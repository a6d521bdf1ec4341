"""Texture atlas sampling (the JAX package's ``ops/texture.py``).

Every image of a scene lives in one padded atlas (scene/compile.py
``_pack_textures``): an [AH, AW, 4] f32 atlas, or a packed RGBA8 atlas
[AH, AW] whose uint32 texels arrive as their int32 bit patterns
(scene/types.py ``SceneSoA.to``).  Filtering is four gathers and a
lerp, or one gather from the quad atlas (each texel's 2x2 bilinear
neighbourhood packed beside it, ``_build_quad_atlas``).  The reference
samples at implicit LOD 0; ``sample_atlas_lod`` adds the trilinear mip
path of the JAX package.

Plain PyTorch on both devices: the JAX package ran this as XLA, outside
any Pallas kernel.  Every gather index is clamped into its array, so a
lane whose result is discarded (a miss, whose t = INF puts uv far out)
never indexes out of bounds; in-range indices are unchanged.
"""

from __future__ import annotations

import torch

WRAP_REPEAT = 10497
WRAP_CLAMP = 33071
WRAP_MIRROR = 33648


def _take(a, idx):
    """Rows of ``a`` at ``idx`` (any shape), the index clamped into range."""
    return a[idx.clamp(0, a.shape[0] - 1).long()]


def _unpack(v):
    """Packed RGBA8 texels (int32 bit patterns) -> [..., 4] f32 in [0, 1].
    ``(v >> 8i) & 0xFF`` is right under the arithmetic shift because of
    the mask; the /255.0 is an IEEE f32 divide, as the f32 packer's."""
    return torch.stack([((v >> (8 * i)) & 0xFF).to(torch.float32) / 255.0
                        for i in range(4)], dim=-1)


def _fetch_rows(atlas, flat):
    """Texel rows by flat index -> [..., 4] f32."""
    if atlas.dim() == 2:  # packed RGBA8
        return _unpack(_take(atlas.reshape(-1), flat))
    return _take(atlas.reshape(-1, 4), flat)


def _wrap(coord, size, mode):
    """Wrap mode applied to integer texel coordinates (floor mod, as
    ``jnp.mod``: torch.remainder, never torch.fmod)."""
    repeat = torch.remainder(coord, size)
    clamp = torch.minimum(torch.maximum(coord, torch.zeros_like(coord)),
                          size - 1)
    period = 2 * size
    m = torch.remainder(torch.remainder(coord, period) + period, period)
    mirror = torch.where(m < size, m, period - 1 - m)
    return torch.where(mode == WRAP_CLAMP, clamp,
                       torch.where(mode == WRAP_MIRROR, mirror, repeat))


def _bilinear(atlas, entry, uv, quad=None):
    """Bilinear fetch of atlas entries [..., >=6] at uv [..., 2].

    With ``quad`` (packed scenes whose wraps are all REPEAT or CLAMP) one
    row gather brings the four corners.  At the CLAMP low edge both true
    corners are texel 0 but the packed neighbour is texel 1, so the
    fetched CORNERS are overridden (c10 := c00), not the lerp weights:
    the blend stays bit-identical to the 4-gather form."""
    x0, y0 = entry[..., 0], entry[..., 1]
    w, h = entry[..., 2], entry[..., 3]
    ws, wt = entry[..., 4], entry[..., 5]
    fx = uv[..., 0] * w.to(torch.float32) - 0.5
    fy = uv[..., 1] * h.to(torch.float32) - 0.5
    ixf = torch.floor(fx)
    iyf = torch.floor(fy)
    ax = (fx - ixf)[..., None]
    ay = (fy - iyf)[..., None]
    ix = ixf.to(torch.int32)
    iy = iyf.to(torch.int32)
    aw = atlas.shape[1]
    if quad is not None:
        lo_s = ((ws == WRAP_CLAMP) & (ix < 0))[..., None]
        lo_t = ((wt == WRAP_CLAMP) & (iy < 0))[..., None]
        px = _wrap(ix, w, ws) + x0
        py = _wrap(iy, h, wt) + y0
        v = _take(quad.reshape(-1, 4), py * aw + px)
        c00 = _unpack(v[..., 0])
        c10 = torch.where(lo_s, c00, _unpack(v[..., 1]))
        c01 = torch.where(lo_t, c00, _unpack(v[..., 2]))
        c11 = torch.where(lo_s, c01,
                          torch.where(lo_t, c10, _unpack(v[..., 3])))
    else:
        def fetch(cx, cy):
            px = _wrap(cx, w, ws) + x0
            py = _wrap(cy, h, wt) + y0
            return _fetch_rows(atlas, py * aw + px)

        c00 = fetch(ix, iy)
        c10 = fetch(ix + 1, iy)
        c01 = fetch(ix, iy + 1)
        c11 = fetch(ix + 1, iy + 1)
    top = c00 * (1 - ax) + c10 * ax
    bot = c01 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def _nearest(atlas, entry, uv):
    """GL NEAREST fetch: the texel at floor(uv * size), wrapped."""
    x0, y0 = entry[..., 0], entry[..., 1]
    w, h = entry[..., 2], entry[..., 3]
    ws, wt = entry[..., 4], entry[..., 5]
    ix = torch.floor(uv[..., 0] * w.to(torch.float32)).to(torch.int32)
    iy = torch.floor(uv[..., 1] * h.to(torch.float32)).to(torch.int32)
    px = _wrap(ix, w, ws) + x0
    py = _wrap(iy, h, wt) + y0
    return _fetch_rows(atlas, py * atlas.shape[1] + px)


def _filtered(atlas, entry, uv, flag_col: int, nearest_aware: bool,
              quad=None):
    if not nearest_aware:
        return _bilinear(atlas, entry, uv, quad=quad)
    nf = entry[..., flag_col] == 1
    return torch.where(nf[..., None], _nearest(atlas, entry, uv),
                       _bilinear(atlas, entry, uv, quad=quad))


def sample_atlas(atlas, table, tex_id, uv, nearest_aware: bool = False,
                 quad=None):
    """LOD-0 texture fetch (path_tracing.comp:244-261): bilinear, or GL
    NEAREST for samplers whose magFilter is NEAREST when
    ``nearest_aware`` (scene.has_nearest).

    atlas [AH, AW, 4] f32 or [AH, AW] int32 (packed RGBA8); table
    [NE, 8] i32 (x, y, w, h, wrap_s, wrap_t, mag_nearest, min_nearest);
    tex_id [...] i32 (callers mask id < 0 themselves); uv [..., 2] f32.
    Returns [..., 4] f32."""
    entry = _take(table, tex_id)
    return _filtered(atlas, entry, uv, 6, nearest_aware, quad=quad)


def sample_atlas_lod(atlas, table, mip_base, mip_count, tex_id, uv, lod,
                     nearest_aware: bool = False, quad=None):
    """Trilinear fetch (cfg.mip_levels > 1): ``lod`` [...] f32, clamped
    to each texture's chain; level-0 taps honour the magFilter flag,
    higher levels the minFilter flag."""
    base = _take(mip_base, tex_id)
    cnt = _take(mip_count, tex_id)
    lv = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)),
                       (cnt - 1).to(torch.float32))
    l0f = torch.floor(lv)
    frac = (lv - l0f)[..., None]
    l0 = l0f.to(torch.int32)
    l1 = torch.minimum(l0 + 1, cnt - 1)
    e0 = _take(table, base + l0)
    e1 = _take(table, base + l1)
    if nearest_aware:
        n0 = torch.where(l0 == 0, e0[..., 6], e0[..., 7]) == 1
        c0 = torch.where(n0[..., None], _nearest(atlas, e0, uv),
                         _bilinear(atlas, e0, uv, quad=quad))
        n1 = e1[..., 7] == 1
        c1 = torch.where(n1[..., None], _nearest(atlas, e1, uv),
                         _bilinear(atlas, e1, uv, quad=quad))
    else:
        c0 = _bilinear(atlas, e0, uv, quad=quad)
        c1 = _bilinear(atlas, e1, uv, quad=quad)
    return c0 * (1.0 - frac) + c1 * frac
