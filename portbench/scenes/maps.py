"""The box of ``box.py`` with every kind of texture map, drawn from a
seed: base colour, emissive (on the lamp), metallic-roughness,
transmission and normal maps of uneven sizes, each with its own wrap
mode on each axis (repeat, clamp, mirror) and its own filter (linear or
nearest, in turn, so that five maps hold every wrap and both filters),
on the walls, the lamp and the spheres.  The walls' uvs run from -1 to
2 and the spheres' wrap twice around, so that every wrap mode is
sampled outside [0, 1]."""

from __future__ import annotations

import numpy as np

from portbench.scenes import box
from portbench.scenes.common import (CLAMP, LINEAR, MIRROR, NEAREST,
                                     REPEAT, TEXTURE_SLOTS, Scene, Texture)

WRAPS = (REPEAT, CLAMP, MIRROR)


def _pixels(rng, kind: str) -> np.ndarray:
    h, w = rng.integers(3, 24, 2)
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if kind == "normal_texture":
        # Tangent-space normals facing out of the surface.
        n = rng.normal(size=(h, w, 3)) * (0.5, 0.5, 0.0) + (0, 0, 1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        px[..., :3] = np.round((n * 0.5 + 0.5) * 255)
    elif kind == "metallic_roughness_texture":
        # Roughness (G) away from 0, where the microfacet walk degenerates.
        px[..., 1] = rng.integers(48, 256, (h, w))
    return px


def _sphere_uvs(pos: np.ndarray) -> np.ndarray:
    """Twice-around spherical uvs of a unit sphere's triangles."""
    u = np.arctan2(pos[..., 2], pos[..., 0]) / np.pi + 1.0
    v = 2.0 * np.arccos(np.clip(pos[..., 1], -1, 1)) / np.pi
    return np.stack([u, v], -1).astype(np.float32)


def make(spheres: int = 4, subdiv: int = 2, seed: int = 0,
         name: str = "maps_box") -> Scene:
    scene = box.make(spheres=spheres, subdiv=subdiv, seed=seed, name=name)
    rng = np.random.default_rng([seed, 7])
    textures = []

    def add(kind: str) -> int:
        k = len(textures)
        textures.append(Texture(
            pixels=_pixels(rng, kind), wrap_s=WRAPS[k % 3],
            wrap_t=WRAPS[(k + 1) % 3],
            mag_filter=(LINEAR, NEAREST)[k % 2],
            min_filter=(NEAREST, LINEAR)[k % 2]))
        return k

    for i, mat in enumerate(scene.materials):
        if mat.name == "light":
            mat.emissive_texture = add("emissive_texture")
            continue
        for kind in TEXTURE_SLOTS:
            # The walls carry every map; each sphere about half of them.
            if kind != "emissive_texture" and (i == 0 or rng.random() < 0.5):
                setattr(mat, kind, add(kind))
    for node in scene.mesh_nodes:
        for p in node.primitives:
            p.uvs = (p.uvs * 3.0 - 1.0 if p.uvs is not None
                     else _sphere_uvs(p.positions))
    scene.textures = textures
    return scene
