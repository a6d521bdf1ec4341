"""The box of ``box.py`` as a PBR scene of Sponza's kind: every material
carries full-size maps drawn from a seed.  The walls' material and each
sphere's have their own base-colour, metallic-roughness and normal maps,
and the lamp an emissive map; the transmission slot stays untextured.
Every map is ``tex_size`` x ``tex_size`` RGBA8 with glTF's usual PBR
sampler (REPEAT on both axes, LINEAR magnification and minification).

The maps are spatially coherent, as painted or scanned ones are, so
that neighbouring pixels tap neighbouring texels: bricks on the walls
and tiles on the spheres, with periodic value noise (each map tiles
seamlessly under REPEAT); roughness (G) kept in 48..255, where the
microfacet walk stays sound, and metallic (B) in patches; tangent-space
normals from the slopes of a height field, facing out.  The walls tile
their maps ``uv_repeat`` times; the spheres take the twice-around
spherical uvs of ``maps.py``."""

from __future__ import annotations

import numpy as np

from portbench.scenes import box
from portbench.scenes.common import LINEAR, REPEAT, Scene, Texture
from portbench.scenes.maps import _sphere_uvs


def _noise(rng, n: int, cells: int) -> np.ndarray:
    """Periodic value noise [n, n] in [0, 1): a random grid of
    ``cells`` x ``cells`` values, smoothstep-interpolated, whose period
    is the map."""
    g = rng.random((cells, cells), dtype=np.float32)
    x = np.arange(n, dtype=np.float32) * np.float32(cells / n)
    i0 = x.astype(np.int64)
    f = x - i0
    f = f * f * (3 - 2 * f)
    i1 = (i0 + 1) % cells
    # Along x on the grid's rows, then along y between them.
    rows = g[:, i0] + (g[:, i1] - g[:, i0]) * f[None, :]
    top, bot = rows[i0], rows[i1]
    return top + (bot - top) * f[:, None]


def _octaves(rng, n: int):
    """Value noise at 4, 16 and 64 cells across the map."""
    return [_noise(rng, n, c) for c in (4, 16, 64)]


def _cells(n: int, rows: int, cols: int, stagger: bool, grout: int):
    """A grid of bricks or tiles over the map: each texel's cell index
    [n, n] and whether it lies in the grout between cells."""
    y = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    ch, cw = n // rows, n // cols
    row = y // ch
    xs = (x + (row % 2) * (cw // 2 if stagger else 0)) % n
    col = xs // cw
    gap = ((y % ch) < grout) | ((xs % cw) < grout)
    return row * cols + col, gap


def _rgba(*channels) -> np.ndarray:
    """An RGBA8 map [n, n, 4] from three channels in [0, 1], alpha 255."""
    n = channels[0].shape[0]
    out = np.full((n, n, 4), 255, np.uint8)
    for k, c in enumerate(channels):
        out[..., k] = np.clip(c, 0.0, 1.0) * np.float32(255) + np.float32(0.5)
    return out


def _pbr_maps(rng, n: int, bricks: bool):
    """(base colour, metallic-roughness, normal) RGBA8 maps [n, n, 4] of
    one material: bricks (staggered, 16 rows of 8) or tiles (8 x 8)."""
    rows, cols = (16, 8) if bricks else (8, 8)
    cell, gap = _cells(n, rows, cols, bricks, max(n // 128, 1))
    o4, o16, o64 = _octaves(rng, n)
    grain = 0.5 * o4 + 0.3 * o16 + 0.2 * o64
    # Base colour: a tint per cell, grain over it, darker grout.
    tint = rng.uniform(0.7, 1.0, (3, rows * cols)).astype(np.float32)
    lum = (0.75 + 0.25 * grain) * np.where(gap, np.float32(0.55),
                                           np.float32(1.0))
    base = _rgba(*(t[cell] * lum for t in tint))
    # Metallic-roughness: R (occlusion) unused, G roughness in 48..255
    # (the grout roughest), B metallic in patches.
    rough = np.where(gap, np.float32(1.0), 0.3 + 0.3 * o16 + 0.3 * o4)
    metal = np.clip((_noise(rng, n, 8) - 0.45) * 4.0, 0.0, 1.0)
    mr = _rgba(np.ones_like(rough), (48 + 207 * rough) / 255, metal)
    # Normal: the slopes of a height field (grout sunk, grain raised) by
    # periodic differences; tangent-space normals facing out.
    h = np.where(gap, np.float32(0.0), np.float32(1.0)) + 0.5 * grain
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * 0.5
    dy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * 0.5
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + np.float32(0.36))
    nrm = _rgba(0.5 - 0.5 * dx * inv, 0.5 - 0.5 * dy * inv,
                0.5 + 0.3 * inv)
    return base, mr, nrm


def _emissive_map(rng, n: int) -> np.ndarray:
    """The lamp's panel: a warm glow with grain, dimmer along a grid."""
    _, gap = _cells(n, 4, 4, False, max(n // 64, 1))
    o4, o16, o64 = _octaves(rng, n)
    glow = ((0.8 + 0.1 * o4 + 0.06 * o16 + 0.04 * o64)
            * np.where(gap, np.float32(0.4), np.float32(1.0)))
    return _rgba(glow, glow * np.float32(0.94), glow * np.float32(0.86))


def make(spheres: int = 10, subdiv: int = 3, seed: int = 0,
         tex_size: int = 1024, uv_repeat: float = 3.0,
         name: str = "pbr_box") -> Scene:
    scene = box.make(spheres=spheres, subdiv=subdiv, seed=seed, name=name)
    rng = np.random.default_rng([seed, 19])
    textures = []

    def add(pixels) -> int:
        textures.append(Texture(pixels=pixels, wrap_s=REPEAT,
                                wrap_t=REPEAT, mag_filter=LINEAR,
                                min_filter=LINEAR))
        return len(textures) - 1

    for i, mat in enumerate(scene.materials):
        if mat.name == "light":
            mat.emissive_texture = add(_emissive_map(rng, tex_size))
            continue
        base, mr, nrm = _pbr_maps(rng, tex_size, bricks=i == 0)
        mat.base_color_texture = add(base)
        mat.metallic_roughness_texture = add(mr)
        mat.normal_texture = add(nrm)
    for node in scene.mesh_nodes:
        for p in node.primitives:
            if p.uvs is None:
                p.uvs = _sphere_uvs(p.positions)
            elif scene.materials[p.material].name != "light":
                p.uvs = (p.uvs * np.float32(uv_repeat)).astype(np.float32)
    scene.textures = textures
    return scene
