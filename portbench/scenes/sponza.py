"""A Sponza-class atrium: the stand-in for Crytek Sponza (Frank Meinl,
Crytek, 2010; glTF-Sample-Models ``2.0/Sponza``), whose asset is not in
the repository.  A long courtyard (30 m x 14 m inside its walls) with
two storeys of arcades on its long sides, walls, floors, ceilings,
curtains, vases and plants, and a roof with an opening over the
courtyard; an emissive panel just above the opening is the sky and the
scene's only emitter (rays that miss everything see the renderer's
constant environment).

Every column, arch, balustrade bay, curtain, vase, plant and wall panel
is its own mesh primitive on its own node (a translation where copies
share one mesh), so each has its own tight bounds, as a real glTF asset
is built.  At ``tri_budget`` = 262,267 (Crytek Sponza's triangle count)
the scene has 154 primitives and 262,260 triangles, split by part
(``part_counts``) as follows:

  columns      36: 18 fluted on the ground storey (14 column_a,
               4 column_c at the rows' ends), 18 plain above (column_b)
                                                   67,680 + 44,928
  arches       32 (arch), every other one 3 cm deeper      12,288
  spandrels     4 walls above the arches, with end piers    6,240
  balustrades  16 bays (details), 8 turned balusters each   31,104
  curtains     12 folded sheets, two of each of six fabrics 27,648
  vases        12: 4 vase_round, 4 vase, 4 vase_hanging     24,960
  plants        8 (4 leaf, 4 thorn), leaves of 8 triangles  20,544
  lions         2 relief medallions on the end walls        15,360
  chains        4 (chain), ten torus links each              8,960
  flagpoles     4 (flagpole)                                 1,792
  sky           1 emissive panel of 32 x 8 quads               512
  walls, floors, ceilings, roof, cornices, backgrounds: 23     244

The geometry's tessellation scales with sqrt(tri_budget / 262,267) and
the leaves take up what is left, so the count lands within a leaf's 8
triangles of the budget; a small budget gives the coarsest atrium,
about 13,000 triangles in the same 154 primitives.

Materials: 25 of Sponza's kinds (stone, bricks, floor, ceiling, roof,
three column kinds, six fabrics, chain and flagpole metal, three vase
kinds, leaf, thorn, arch, details, lion and background), each with
seeded ``tex_size``-square base-colour, metallic-roughness and
tangent-space normal maps (REPEAT and LINEAR, at real-world uv scales;
roughness G in 48..255, metallic only on the metals), and the sky
panel's material with one emissive map, a seeded sky gradient: 76 maps.
No transmission; leaves are opaque (no alpha mask).
"""

from __future__ import annotations

import re

import numpy as np

from portbench.scenes.box_pbr import _cells, _octaves, _rgba
from portbench.scenes.common import (LINEAR, REPEAT, CameraNode, Material,
                                     MeshNode, Primitive, Scene, Texture,
                                     look_at)

SPONZA_TRIANGLES = 262_267

# Half extents of the hall inside its walls, the column rows' z, the
# storeys' levels (floor top, impost, spandrel top, slab top).
HX, HZ, CZ = 15.0, 7.0, 3.5
GROUND = (0.0, 5.0, 7.4, 7.7)
UPPER = (7.7, 11.1, 13.2, 13.6)
BAYS = 8                  # arches a row, 3 m each, columns at x = -12..12
SPAN = 3.0
R_IN, R_OUT = 1.2, 1.7    # arch intrados and extrados radii
ARCH_DEPTH = 0.35         # half depth of an arch along z
WALL_HALF = 0.3           # half thickness of a spandrel wall
OPEN_X, OPEN_Z = 13.0, 3.2  # the roof opening's half extents
SKY_Y = 14.2

# name: (pattern, base tint, metallic factor, metres a map repeat)
KINDS = {
    "arch": ("blocks", (0.78, 0.72, 0.62), 0.0, 1.5),
    "bricks": ("bricks", (0.66, 0.42, 0.32), 0.0, 2.0),
    "ceiling": ("plaster", (0.85, 0.82, 0.76), 0.0, 2.0),
    "chain": ("metal", (0.55, 0.5, 0.45), 1.0, 0.3),
    "column_a": ("veined", (0.82, 0.78, 0.7), 0.0, 1.0),
    "column_b": ("veined", (0.74, 0.7, 0.66), 0.0, 1.0),
    "column_c": ("veined", (0.7, 0.66, 0.58), 0.0, 1.0),
    "details": ("blocks", (0.8, 0.76, 0.68), 0.0, 1.0),
    "fabric_a": ("weave", (0.62, 0.12, 0.1), 0.0, 1.0),
    "fabric_c": ("weave", (0.12, 0.36, 0.18), 0.0, 1.0),
    "fabric_d": ("weave", (0.14, 0.2, 0.5), 0.0, 1.0),
    "fabric_e": ("weave", (0.66, 0.5, 0.14), 0.0, 1.0),
    "fabric_f": ("weave", (0.5, 0.14, 0.36), 0.0, 1.0),
    "fabric_g": ("weave", (0.2, 0.46, 0.5), 0.0, 1.0),
    "flagpole": ("metal", (0.5, 0.46, 0.4), 1.0, 0.5),
    "floor": ("tiles", (0.62, 0.58, 0.52), 0.0, 2.0),
    "leaf": ("leaf", (0.2, 0.42, 0.14), 0.0, 1.0),
    "lion": ("plaster", (0.76, 0.72, 0.64), 0.0, 1.0),
    "roof": ("tiles", (0.56, 0.3, 0.22), 0.0, 1.5),
    "vase": ("glaze", (0.6, 0.44, 0.3), 0.0, 0.6),
    "vase_hanging": ("glaze", (0.5, 0.52, 0.46), 0.0, 0.5),
    "vase_round": ("glaze", (0.7, 0.6, 0.46), 0.0, 0.8),
    "background": ("plaster", (0.7, 0.62, 0.5), 0.0, 2.0),
    "stone": ("blocks", (0.76, 0.7, 0.6), 0.0, 2.0),
    "thorn": ("veined", (0.3, 0.36, 0.16), 0.0, 0.5),
}
FABRICS = ("fabric_a", "fabric_c", "fabric_d", "fabric_e", "fabric_f",
           "fabric_g")
SKY_EMISSION = (5.0, 5.0, 5.0)


# -- maps -------------------------------------------------------------------

def _pbr_maps(rng, n: int, pattern: str, tint, metal: float):
    """(base colour, metallic-roughness, normal) RGBA8 maps [n, n, 4]:
    a grid of cells (blocks, bricks, tiles) or none, grain from periodic
    value noise, threads for fabrics, veins for marble and leaves."""
    grid = {"blocks": (8, 4, True), "bricks": (32, 8, True),
            "tiles": (8, 8, False)}.get(pattern)
    o4, o16, o64 = _octaves(rng, n)
    grain = 0.5 * o4 + 0.3 * o16 + 0.2 * o64
    if grid is not None:
        rows, cols, stagger = min(grid[0], n // 2), min(grid[1], n // 2), \
            grid[2]
        cell, gap = _cells(n, rows, cols, stagger, max(n // 128, 1))
        var = rng.uniform(0.8, 1.0, rows * cols).astype(np.float32)[cell]
    else:
        gap = np.zeros((n, n), bool)
        var = np.ones((n, n), np.float32)
    x = np.arange(n, dtype=np.float32)[None, :] * np.float32(2 * np.pi / n)
    y = np.arange(n, dtype=np.float32)[:, None] * np.float32(2 * np.pi / n)
    relief = np.zeros((n, n), np.float32)
    if pattern == "weave":
        k = np.float32(max(n // 16, 1))
        relief = 0.25 * np.sin(k * x) * np.sin(k * y)
        var = var * (0.8 + 0.2 * (np.sin(np.float32(8) * x) > 0))
    elif pattern in ("veined", "leaf"):
        relief = 0.3 * np.abs(np.sin(np.float32(3) * x + 4 * o4))
    lum = (0.7 + 0.3 * grain) * var * np.where(gap, np.float32(0.55),
                                               np.float32(1.0))
    if pattern == "weave" or pattern in ("veined", "leaf"):
        lum = lum * (0.85 + 0.3 * relief)
    base = _rgba(*(np.float32(t) * lum for t in tint))
    smooth = {"metal": 0.15, "glaze": 0.2, "veined": 0.3}.get(pattern, 0.5)
    rough = np.where(gap, np.float32(1.0),
                     smooth + (1.0 - smooth) * (0.5 * o16 + 0.5 * o4))
    metallic = (np.clip(0.75 + 0.5 * o16, 0.0, 1.0) if metal > 0
                else np.zeros((n, n), np.float32))
    mr = _rgba(np.ones_like(rough), (48 + 207 * rough) / 255, metallic)
    h = np.where(gap, np.float32(0.0), np.float32(1.0)) + 0.5 * grain \
        + relief
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * 0.5
    dy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * 0.5
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + np.float32(0.36))
    nrm = _rgba(0.5 - 0.5 * dx * inv, 0.5 - 0.5 * dy * inv,
                0.5 + 0.3 * inv)
    return base, mr, nrm


def _sky_map(rng, n: int) -> np.ndarray:
    """The sky panel's emission: bright toward one end of the nave (the
    sun's side), bluish toward the other, with soft clouds."""
    o4, o16, _ = _octaves(rng, n)
    u = np.linspace(0.0, 1.0, n, dtype=np.float32)[None, :]
    glow = 0.55 + 0.45 * u * u + 0.1 * (o4 - 0.5) + 0.05 * (o16 - 0.5)
    glow = np.broadcast_to(glow, (n, n))
    return _rgba(glow, glow * np.float32(0.96),
                 glow * (np.float32(1.0) - 0.12 * u))


# -- geometry ---------------------------------------------------------------

def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _finish(pos, nrm, uv):
    """Triangles whose winding agrees with their shading normals (a
    triangle facing against its normals is flipped), without degenerate
    ones; float32."""
    pos, nrm, uv = (np.asarray(a, np.float32) for a in (pos, nrm, uv))
    g = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    area = np.linalg.norm(g, axis=1)
    keep = area > 1e-9 * max(float(area.max(initial=0.0)), 1e-30)
    flip = (g * nrm.sum(axis=1)).sum(axis=1) < 0
    for a in (pos, nrm, uv):
        a[flip] = a[flip][:, [0, 2, 1]]
    return pos[keep], nrm[keep], uv[keep]


def _cat(*parts):
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def _sweep(path, fn, fb, section, closed_path=False, closed_section=True,
           smooth=True):
    """A cross-section swept along a path: ``section`` [J, 2] (a, b),
    counter-clockwise, placed at each path point [K, 3] as point + a fn
    + b fb.  Quads between consecutive path points and section points;
    normals outward from the section's edges (smooth: averaged at its
    vertices); uvs in metres along the section and the path.  Returns
    (positions, normals, uvs) [T, 3, k]."""
    path, fn, fb = (np.asarray(a, np.float64) for a in (path, fn, fb))
    sec = np.asarray(section, np.float64)
    if closed_path:
        path, fn, fb = (np.concatenate([a, a[:1]]) for a in (path, fn, fb))
    if closed_section:
        sec = np.concatenate([sec, sec[:1]])
    d = np.diff(sec, axis=0)
    en = _unit(np.stack([d[:, 1], -d[:, 0]], -1))     # [E, 2]
    if smooth:
        prev = np.concatenate([en[-1:] if closed_section else en[:1], en])
        nxt = np.concatenate([en, en[:1] if closed_section else en[-1:]])
        vn = _unit(prev + nxt)                        # [E + 1, 2]
        n0, n1 = vn[:-1], vn[1:]
    else:
        n0 = n1 = en
    s_u = np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])
    s_v = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(path + sec[0, 0] * fn, axis=0), axis=1))])
    pts = (path[:, None] + sec[None, :, 0, None] * fn[:, None]
           + sec[None, :, 1, None] * fb[:, None])     # [K, J, 3]

    def world_n(nn, k):                                # [E, 2] -> [K, E, 3]
        return _unit(nn[None, :, 0, None] * fn[k][:, None]
                     + nn[None, :, 1, None] * fb[k][:, None])

    k0 = np.arange(len(path) - 1)
    k1 = k0 + 1
    a, b = pts[k0][:, :-1], pts[k1][:, :-1]
    c, e = pts[k1][:, 1:], pts[k0][:, 1:]
    na, nb = world_n(n0, k0), world_n(n0, k1)
    nc, ne = world_n(n1, k1), world_n(n1, k0)
    uu0, uu1 = s_u[:-1][None, :], s_u[1:][None, :]
    vv0, vv1 = s_v[k0][:, None], s_v[k1][:, None]
    shape = a.shape[:2]

    def uv(u, v):
        return np.stack(np.broadcast_arrays(u, v), -1).reshape(*shape, 2)

    ua, ub, uc, ue = uv(uu0, vv0), uv(uu0, vv1), uv(uu1, vv1), uv(uu1, vv0)
    pos = np.concatenate([np.stack([a, b, c], 2), np.stack([a, c, e], 2)])
    nrm = np.concatenate([np.stack([na, nb, nc], 2),
                          np.stack([na, nc, ne], 2)])
    uvs = np.concatenate([np.stack([ua, ub, uc], 2),
                          np.stack([ua, uc, ue], 2)])
    return _finish(pos.reshape(-1, 3, 3), nrm.reshape(-1, 3, 3),
                   uvs.reshape(-1, 3, 2))


def _lathe(profile, segments: int):
    """A profile [J, 2] (radius, height), bottom to top, revolved about
    the y axis in ``segments`` steps."""
    th = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    radial = np.stack([np.cos(th), np.zeros_like(th), -np.sin(th)], -1)
    up = np.broadcast_to([0.0, 1.0, 0.0], radial.shape)
    return _sweep(np.zeros_like(radial), radial, up, profile,
                  closed_path=True, closed_section=False)


def _line(p0, p1, fn, steps: int = 1):
    """A straight path from p0 to p1 with a constant frame (fn, and
    fb = its cross with the direction)."""
    p0, p1, fn = (np.asarray(v, np.float64) for v in (p0, p1, fn))
    t = np.linspace(0.0, 1.0, steps + 1)[:, None]
    path = p0 + t * (p1 - p0)
    fb = np.cross(_unit(p1 - p0), fn)
    return path, np.broadcast_to(fn, path.shape), np.broadcast_to(
        fb, path.shape)


def _circle(r, n: int, flutes: int = 0, depth: float = 0.0):
    """A counter-clockwise circle [n, 2], fluted if asked."""
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    rr = r * (1.0 - depth * (0.5 - 0.5 * np.cos(flutes * th)))
    return np.stack([rr * np.cos(th), rr * np.sin(th)], -1)


def _box(lo, hi):
    """An axis-aligned box, outward normals, uvs from the face's world
    coordinates."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    tris, nrm, uvs = [], [], []
    for ax in range(3):
        u, v = (ax + 1) % 3, (ax + 2) % 3
        for side, w in ((-1, lo[ax]), (1, hi[ax])):
            q = np.zeros((4, 3))
            q[:, ax] = w
            q[:, u] = (lo[u], hi[u], hi[u], lo[u])
            q[:, v] = (lo[v], lo[v], hi[v], hi[v])
            n = np.zeros(3)
            n[ax] = side
            t = np.stack([q[[0, 1, 2]], q[[0, 2, 3]]])
            tris.append(t)
            nrm.append(np.broadcast_to(n, t.shape))
            uvs.append(t[..., [u, v]])
    return _finish(np.concatenate(tris), np.concatenate(nrm),
                   np.concatenate(uvs))


def _sheet(corner, du, dv, nu: int, nv: int, offset=None, tile=1.0):
    """A grid of nu x nv quads from ``corner`` along du, dv, displaced
    along their normal by offset(s, t) (s, t in [0, 1]); smooth normals
    by differences of the displaced grid, facing du x dv; uvs in units of
    ``tile`` metres (a pair: one a direction)."""
    corner, du, dv = (np.asarray(v, np.float64) for v in (corner, du, dv))
    s = np.linspace(0.0, 1.0, nu + 1)[None, :, None]
    t = np.linspace(0.0, 1.0, nv + 1)[:, None, None]
    n0 = _unit(np.cross(du, dv))
    p = corner + s * du + t * dv
    if offset is not None:
        p = p + offset(s[..., 0], t[..., 0])[..., None] * n0
    gu = np.gradient(p, axis=1)
    gv = np.gradient(p, axis=0)
    nrm = _unit(np.cross(gu, gv))
    uvw = np.concatenate(np.broadcast_arrays(
        s * np.linalg.norm(du), t * np.linalg.norm(dv)), -1) / np.asarray(
        tile, np.float64)

    def quads(a):
        a0, a1 = a[:-1, :-1], a[:-1, 1:]
        b1, b0 = a[1:, 1:], a[1:, :-1]
        return np.concatenate([np.stack([a0, a1, b1], 2),
                               np.stack([a0, b1, b0], 2)]).reshape(
            -1, 3, a.shape[-1])
    return _finish(quads(p), quads(nrm), quads(uvw))


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


# -- parts ------------------------------------------------------------------

def _seg(base: int, f: float, lo: int = 3) -> int:
    return max(lo, int(round(base * f)))


def _column(f: float, storey, fluted: bool):
    """A column from its floor to its impost, in object space about its
    axis: a moulded base, the shaft (fluted: 20 flutes) and a capital."""
    y0, y1 = 0.0, storey[1] - storey[0]
    r = 0.3 if fluted else 0.24
    segs = _seg(40 if fluted else 32, f, 6)
    ring = _seg(12, f, 2)
    a = np.linspace(0.0, np.pi, ring + 1)
    base = np.concatenate([
        [[r + 0.14, y0 - 0.05], [r + 0.14, y0 + 0.12]],
        np.stack([r + 0.05 + 0.07 * np.sin(a), y0 + 0.14 + 0.1 * (
            1 - np.cos(a)) / 2 * 2], -1),
        [[r + 0.02, y0 + 0.38]]])
    cap = np.concatenate([
        [[r, y1 - 0.42]],
        np.stack([r + 0.04 + 0.16 * (1 - np.cos(a / 2)),
                  y1 - 0.38 + 0.26 * a / np.pi], -1),
        [[r + 0.26, y1 - 0.1], [r + 0.26, y1 + 0.01], [0.001, y1 + 0.01]]])
    shaft_path = _line((0, y0 + 0.38, 0), (0, y1 - 0.42, 0), (1, 0, 0),
                       _seg(16 if fluted else 8, f, 1))
    sec = _circle(r, segs, flutes=20 if fluted else 0,
                  depth=0.08 if fluted else 0.0)
    # The path runs up: the section's plane is x (a) and -z (b).
    shaft = _sweep(*shaft_path, sec)
    return _cat(_lathe(base, segs), shaft, _lathe(cap, segs))


def _arch(f: float, depth: float):
    """One arch (object space: centred at its bay's centre, on its
    impost line): a rectangular section ``2 depth`` deep swept along a
    half circle."""
    k = _seg(48, f, 4)
    th = np.linspace(np.pi, 0.0, k + 1)
    radial = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
    fb = np.broadcast_to([0.0, 0.0, 1.0], radial.shape)
    rm, half = (R_IN + R_OUT) / 2, (R_OUT - R_IN) / 2
    sec = [(-half, -depth), (half, -depth), (half, depth), (-half, depth)]
    return _sweep(radial * rm, radial, fb, sec, smooth=False)


def _spandrels(f: float, storey):
    """The wall of one arcade row above its arches, between the extrados
    and the storey's spandrel top, and the piers from the end columns to
    the end walls (world space, on the +z row; mirrored by the node)."""
    k = _seg(48, f, 4)
    y0, yi, yt = storey[0], storey[1], storey[2]
    # The extrados within the bay (|x| <= SPAN / 2 of its centre): below
    # its ends the neighbouring arches meet over their column.
    t0 = np.arccos(SPAN / 2 / R_OUT)
    th = np.linspace(np.pi - t0, t0, k + 1)
    parts = []
    for i in range(BAYS):
        cx = -SPAN * BAYS / 2 + SPAN * (i + 0.5)
        arc = np.stack([cx + R_OUT * np.cos(th), yi + R_OUT * np.sin(th)],
                       -1)
        # The wall above each arc point, straight up to the top.
        top = np.stack([arc[:, 0], np.full(k + 1, yt)], -1)
        for z, side in ((CZ - WALL_HALF, -1), (CZ + WALL_HALF, 1)):
            a3 = np.concatenate([arc, np.full((k + 1, 1), z)], 1)
            t3 = np.concatenate([top, np.full((k + 1, 1), z)], 1)
            tri = np.concatenate([
                np.stack([a3[:-1], a3[1:], t3[1:]], 1),
                np.stack([a3[:-1], t3[1:], t3[:-1]], 1)])
            n = np.broadcast_to([0.0, 0.0, side], tri.shape)
            parts.append(_finish(tri, n, tri[..., :2]))
    for sx in (-1, 1):
        # Into the end wall, so that no face of a pier is coplanar with
        # the wall's.
        xa, xb = sorted((sx * SPAN * BAYS / 2, sx * (HX + 0.15)))
        parts.append(_box((xa, y0 - 0.05, CZ - WALL_HALF),
                          (xb, yt, CZ + WALL_HALF)))
    return _cat(*parts)


def _balustrade(f: float):
    """One bay's balustrade (object space: the bay's centre on the upper
    floor): two rails and 8 turned balusters."""
    segs = _seg(12, f, 4)
    ring = _seg(10, f, 2)
    a = np.linspace(0.0, 1.0, ring + 1)
    prof = np.stack([0.05 + 0.05 * np.sin(np.pi * a) ** 2
                     + 0.02 * np.sin(3 * np.pi * a) ** 2,
                     0.15 + 0.7 * a], -1)
    half = SPAN / 2 - 0.3
    parts = [_box((-half, -0.02, -0.12), (half, 0.15, 0.12)),
             _box((-half, 0.85, -0.1), (half, 1.0, 0.1))]
    baluster = _lathe(prof, segs)
    for x in np.linspace(-half + 0.17, half - 0.17, 8):
        p = baluster[0] + np.array([x, 0.0, 0.0], np.float32)
        parts.append((p, baluster[1], baluster[2]))
    return _cat(*parts)


def _curtain(f: float, rng, width=2.2, height=3.4):
    """A hanging curtain (object space: its top centre): a sheet with
    vertical folds that deepen toward the hem."""
    folds = rng.uniform(5.0, 8.0)
    phase = rng.uniform(0, 2 * np.pi)

    def offset(s, t):
        return (0.06 + 0.08 * (1 - t)) * np.sin(2 * np.pi * folds * s
                                                + phase)
    return _sheet((-width / 2, -height, 0.0), (width, 0, 0), (0, height, 0),
                  _seg(48, f, 2), _seg(24, f, 2), offset)


def _vase(f: float, kind: str):
    """A turned vase (object space: its foot at the origin)."""
    segs = _seg(40, f, 6)
    ring = _seg(24, f, 3)
    a = np.linspace(0.0, 1.0, ring + 1)
    if kind == "vase_round":
        r = 0.08 + 0.5 * np.sin(np.pi * (0.1 + 0.8 * a)) ** 1.2
        y = 1.0 * a
    elif kind == "vase":
        r = 0.12 + 0.28 * np.sin(np.pi * a) ** 2 + 0.1 * a ** 6
        y = 1.3 * a
    else:
        r = 0.05 + 0.25 * np.sin(np.pi * (0.05 + 0.85 * a))
        y = 0.6 * a
    # Out and over the lip, then down inside it.
    prof = np.concatenate([np.stack([r, y], -1),
                           [[r[-1] * 0.9, y[-1] + 0.02],
                            [r[-1] * 0.85, y[-1] - 0.1]]])
    return _lathe(prof, segs)


def _chain(f: float, links: int = 10):
    """Torus links hanging down from the origin, each turned a quarter
    from the last."""
    segs, ring = _seg(14, f, 3), _seg(8, f, 3)
    th = np.linspace(0.0, 2 * np.pi, segs, endpoint=False)
    parts = []
    for i in range(links):
        ex = np.array([1.0, 0, 0]) if i % 2 == 0 else np.array([0, 0, 1.0])
        centre = np.array([0.0, -0.06 - 0.11 * i, 0.0])
        path = (centre + 0.035 * np.cos(th)[:, None] * ex
                + 0.07 * np.sin(th)[:, None] * np.array([0, 1.0, 0]))
        tang = _unit(np.roll(path, -1, 0) - np.roll(path, 1, 0))
        fb = np.broadcast_to(np.cross(ex, [0.0, 1.0, 0.0]), path.shape)
        fn = np.cross(tang, fb)
        fn *= np.sign((fn * (path - centre)).sum(axis=1))[:, None]
        parts.append(_sweep(path, fn, fb, _circle(0.012, ring),
                            closed_path=True))
    return _cat(*parts)


def _flagpole(f: float):
    """A pole leaning out of the wall toward the courtyard (object
    space: its foot at the origin, leaning toward -z), with a knob."""
    segs = _seg(16, f, 4)
    d = _unit(np.array([0.0, 0.6, -1.0]))
    pole = _sweep(*_line((0, 0, 0), 2.2 * d, (1, 0, 0), _seg(6, f, 1)),
                  _circle(0.035, segs))
    a = np.linspace(0.0, np.pi, _seg(8, f, 3) + 1)
    knob = _lathe(np.stack([0.001 + 0.07 * np.sin(a), -0.07 * np.cos(a)],
                           -1), segs)
    return _cat(pole, (knob[0] + (2.25 * d).astype(np.float32), knob[1],
                       knob[2]))


def _lion(f: float):
    """A relief medallion on an end wall (object space: facing +x from
    the origin): a ridged disc of rings turned about x."""
    segs = _seg(96, f, 6)
    ring = _seg(40, f, 3)
    a = np.linspace(0.0, 1.0, ring + 1)
    r = 0.001 + 0.9 * a
    h = 0.25 * np.cos(0.5 * np.pi * a) + 0.04 * np.sin(9 * np.pi * a)
    pos, nrm, uv = _lathe(np.stack([r, h], -1)[::-1], segs)
    # Turn the medallion's y axis onto x.
    rot = np.array([[0, 1.0, 0], [-1.0, 0, 0], [0, 0, 1.0]], np.float32)
    return pos @ rot.T, nrm @ rot.T, uv


def _plant(rng, kind: str, n: int, f: float):
    """A bush of ``n`` leaves (object space: rising from the origin):
    each leaf a bent 2 x 2 sheet; a thorn bush has stems as well."""
    parts = []
    if kind == "thorn":
        segs = _seg(6, f, 3)
        for _ in range(5):
            tip = np.array([rng.uniform(-0.4, 0.4), rng.uniform(0.8, 1.3),
                            rng.uniform(-0.4, 0.4)])
            parts.append(_sweep(*_line((0, 0, 0), tip, _unit(np.cross(
                tip, [0.0, 0.0, 1.0]))), _circle(0.015, segs)))
    for _ in range(n):
        yaw = rng.uniform(0, 2 * np.pi)
        pitch = rng.uniform(0.2, 1.2)
        out = np.array([np.cos(yaw) * np.cos(pitch), np.sin(pitch),
                        np.sin(yaw) * np.cos(pitch)])
        side = _unit(np.cross(out, [0.0, 1.0, 0.0])) * rng.uniform(0.06,
                                                                   0.1)
        length = rng.uniform(0.25, 0.45)
        root = rng.uniform(0.1, 0.5) * out + np.array(
            [0, rng.uniform(0.05, 0.35), 0])
        bend = rng.uniform(0.05, 0.15)

        def offset(s, t, bend=bend):
            return bend * t * t - 0.02 * np.sin(np.pi * s)
        parts.append(_sheet(root - side / 2, side, out * length, 2, 2,
                            offset))
    return _cat(*parts)


# -- the scene --------------------------------------------------------------

def make(seed: int = 0, tex_size: int = 1024,
         tri_budget: int = SPONZA_TRIANGLES,
         name: str = "sponza_atrium") -> Scene:
    rng = np.random.default_rng([seed, 24])
    # The geometry's own draws, so that it does not depend on the maps'
    # size.
    geo = np.random.default_rng([seed, 25])
    f = float(np.sqrt(max(tri_budget, 1) / SPONZA_TRIANGLES))
    textures = []

    def add(pixels) -> int:
        textures.append(Texture(pixels=pixels, wrap_s=REPEAT,
                                wrap_t=REPEAT, mag_filter=LINEAR,
                                min_filter=LINEAR))
        return len(textures) - 1

    materials, mat = [], {}
    for kname, (pattern, tint, metal, _) in KINDS.items():
        base, mr, nrm = _pbr_maps(rng, tex_size, pattern, tint, metal)
        mat[kname] = len(materials)
        materials.append(Material(
            name=kname, metallic_factor=metal, roughness_factor=1.0,
            base_color_texture=add(base),
            metallic_roughness_texture=add(mr), normal_texture=add(nrm)))
    mat["sky"] = len(materials)
    materials.append(Material(
        name="sky", emissive_factor=np.array(SKY_EMISSION, np.float32),
        base_color_factor=np.array([0.0, 0.0, 0.0, 1.0], np.float32),
        metallic_factor=0.0, roughness_factor=1.0,
        emissive_texture=add(_sky_map(rng, tex_size))))

    nodes = []

    def put(nm, geo, kind, world=None):
        """A node of one primitive; its uvs (metres) in repeats of the
        material's maps."""
        pos, nrm, uv = geo
        if kind in KINDS:
            uv = (uv / np.float32(KINDS[kind][3])).astype(np.float32)
        nodes.append(MeshNode(
            name=nm, world_matrix=(np.eye(4, dtype=np.float32)
                                   if world is None else world),
            primitives=[Primitive(pos, nrm, uv, mat[kind])]))

    # Copies on the -z side are turned half about y, never mirrored.
    turn = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    xs = [-SPAN * BAYS / 2 + SPAN * i for i in range(BAYS + 1)]
    bays = [x + SPAN / 2 for x in xs[:-1]]
    ground_col = _column(f, GROUND, fluted=True)
    upper_col = _column(f, UPPER, fluted=False)
    for sz in (1, -1):
        for i, x in enumerate(xs):
            kind = "column_c" if i in (0, BAYS) else "column_a"
            put(f"column_g{sz:+d}_{i}", ground_col, kind,
                _translate(x, GROUND[0], sz * CZ))
            put(f"column_u{sz:+d}_{i}", upper_col, "column_b",
                _translate(x, UPPER[0], sz * CZ))
    # Neighbouring arches overlap over their column: every other one is
    # 3 cm deeper, so that their faces are never coplanar.
    arches = (_arch(f, ARCH_DEPTH), _arch(f, ARCH_DEPTH + 0.015))
    for sz in (1, -1):
        for st, lv in (("g", GROUND), ("u", UPPER)):
            for i, x in enumerate(bays):
                put(f"arch_{st}{sz:+d}_{i}", arches[i % 2], "arch",
                    _translate(x, lv[1], sz * CZ))
    for sz in (1, -1):
        for st, lv in (("g", GROUND), ("u", UPPER)):
            put(f"spandrel_{st}{sz:+d}", _spandrels(f, lv), "stone",
                None if sz > 0 else turn)
    bal = _balustrade(f)
    for sz in (1, -1):
        for i, x in enumerate(bays):
            put(f"balustrade{sz:+d}_{i}", bal, "details",
                _translate(x, UPPER[0], sz * CZ))
    # Curtains behind six of each upper row's arches, facing the
    # courtyard.
    for sz in (1, -1):
        for j, i in enumerate((0, 1, 3, 4, 6, 7)):
            fab = FABRICS[j if sz > 0 else 5 - j]
            world = _translate(bays[i], UPPER[1] + 1.1, sz * (CZ + 0.45))
            put(f"curtain{sz:+d}_{i}", _curtain(f, geo), fab,
                world @ turn if sz > 0 else world)

    # Walls, floors, ceilings, roof, cornices: boxes and sheets.  Where
    # two meet, one reaches into the other (the outer walls into the end
    # walls, the end roofs into the long ones, 1 cm thinner), so that no
    # two objects' faces are coplanar where a ray can reach them: a tie
    # there would be settled differently by the program and the
    # reference.
    y_top = UPPER[3]
    put("floor", _box((-HX, -0.3, -HZ), (HX, 0.0, HZ)), "floor")
    for sz, nm in ((1, "n"), (-1, "s")):
        z0, z1 = sorted((sz * (CZ - 0.35), sz * HZ))
        za, zb = sorted((sz * (CZ + 0.36), sz * HZ))
        put(f"floor_upper_{nm}", _box((-HX, GROUND[2], z0),
                                      (HX, GROUND[3], z1)), "floor")
        for st, lv in (("g", GROUND), ("u", UPPER)):
            put(f"ceiling_{st}_{nm}", _sheet((-HX, lv[2] - 0.02, za),
                                             (2 * HX, 0, 0),
                                             (0, 0, zb - za), 1, 1),
                "ceiling")
        w0, w1 = sorted((sz * HZ, sz * (HZ + 0.3)))
        wx = HX + 0.15
        put(f"wall_g_{nm}", _box((-wx, -0.2, w0),
                                 (wx, GROUND[3] - 0.15, w1)), "bricks")
        put(f"wall_u_{nm}", _box((-wx, GROUND[3] - 0.15, w0),
                                 (wx, y_top - 0.2, w1)), "bricks")
        r0, r1 = sorted((sz * OPEN_Z, sz * (HZ + 0.3)))
        put(f"roof_{nm}", _box((-HX - 0.3, UPPER[2], r0),
                               (HX + 0.3, y_top, r1)), "roof")
    for sx, nm in ((1, "e"), (-1, "w")):
        x0, x1 = sorted((sx * OPEN_X, sx * (HX + 0.3)))
        put(f"roof_{nm}", _box((x0, UPPER[2] + 0.01, -OPEN_Z - 0.1),
                               (x1, y_top - 0.01, OPEN_Z + 0.1)), "roof")
        e0, e1 = sorted((sx * HX, sx * (HX + 0.3)))
        put(f"wall_end_{nm}", _box((e0, -0.2, -HZ - 0.3),
                                   (e1, y_top - 0.2, HZ + 0.3)), "stone")
        b0, b1 = sorted((sx * (HX - 0.06), sx * (HX + 0.1)))
        put(f"background_{nm}", _box((b0, 1.0, -2.6), (b1, 6.2, 2.6)),
            "background")
        face = turn.copy() if sx > 0 else np.eye(4, dtype=np.float32)
        face[:3, 3] = (sx * (HX - 0.06), 3.6, 0.0)
        put(f"lion_{nm}", _lion(f), "lion", face)
    # A moulding along the top of each arcade wall's courtyard face: the
    # path runs along +x with a toward the courtyard (-z) and b up; its
    # back sits 1 cm inside the wall.
    molding = [(-0.01, -0.2), (0.12, -0.2), (0.12, -0.1), (0.2, -0.05),
               (0.24, 0.05), (0.24, 0.2), (-0.01, 0.2)]
    for sz in (1, -1):
        for st, lv in (("g", GROUND), ("u", UPPER)):
            path = _line((-HX + 0.01, lv[2] - 0.2, CZ - WALL_HALF),
                         (HX - 0.01, lv[2] - 0.2, CZ - WALL_HALF),
                         (0, 0, -1))
            put(f"cornice_{st}{sz:+d}", _sweep(*path, molding, smooth=False),
                "details", None if sz > 0 else turn)

    # Vases with plants on the courtyard floor, vases hanging on chains
    # under four ground arches, flagpoles out of the upper walls.
    vr, vv, vh = (_vase(f, k) for k in ("vase_round", "vase",
                                        "vase_hanging"))
    spots = [(-11.0, 2.2), (11.0, -2.2), (-11.0, -2.2), (11.0, 2.2)]
    for i, (x, z) in enumerate(spots):
        put(f"vase_round_{i}", vr, "vase_round", _translate(x, -0.01, z))
    for i, (x, z) in enumerate([(-5.0, 2.4), (5.0, -2.4), (-5.0, -2.4),
                                (5.0, 2.4)]):
        put(f"vase_{i}", vv, "vase", _translate(x, -0.01, z))
        spots.append((x, z))
    chain = _chain(f)
    top = GROUND[1] + R_IN
    for i, (x, sz) in enumerate([(bays[1], 1), (bays[6], -1),
                                 (bays[3], -1), (bays[4], 1)]):
        put(f"chain_{i}", chain, "chain", _translate(x, top, sz * CZ))
        put(f"vase_hanging_{i}", vh, "vase_hanging",
            _translate(x, top - 1.75, sz * CZ))
    pole = _flagpole(f)
    for i, (x, sz) in enumerate([(-9.0, 1), (-3.0, -1), (3.0, 1),
                                 (9.0, -1)]):
        world = _translate(x, UPPER[1] + 1.6, sz * (CZ - WALL_HALF))
        put(f"flagpole_{i}", pole, "flagpole",
            world if sz > 0 else world @ turn)

    # The sky: a subdivided emissive panel over the roof's opening,
    # facing down, its map once across it.
    w, d = 2 * OPEN_X + 1.0, 2 * OPEN_Z + 1.0
    put("sky", _sheet((-w / 2, SKY_Y, -d / 2), (w, 0, 0), (0, 0, d), 32, 8,
                      tile=(w, d)), "sky")

    # Plants take the rest of the budget: leaves of 8 triangles.
    used = sum(p.positions.shape[0] for n in nodes for p in n.primitives)
    stems = 4 * 5 * 2 * _seg(6, f, 3)
    leaves = max(8, (tri_budget - used - stems) // 8)
    for i, (x, z) in enumerate(spots):
        kind = "leaf" if i < 4 else "thorn"
        share = leaves // 8 + (1 if i < leaves % 8 else 0)
        y = 0.95 if i < 4 else 1.25
        put(f"plant_{i}", _plant(geo, kind, share, f), kind,
            _translate(x, y, z))

    cam = CameraNode(name="camera",
                     world_matrix=look_at((-HX + 1.4, 1.7, 0.0),
                                          (HX, 4.2, 0.0)), yfov=1.0)
    return Scene(mesh_nodes=nodes, cameras=[cam], materials=materials,
                 name=name, textures=textures)


def part_counts(scene: Scene) -> dict:
    """Triangles by part: node names up to their first "_", "+" or
    "-"."""
    out = {}
    for n in scene.mesh_nodes:
        key = re.split(r"[_+-]", n.name)[0]
        out[key] = out.get(key, 0) + sum(p.positions.shape[0]
                                          for p in n.primitives)
    return out
