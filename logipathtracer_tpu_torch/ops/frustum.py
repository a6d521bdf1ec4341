"""Per-tile conservative cluster culling for the streamed sweep (the JAX
package's ``ops/frustum.py``, operation for operation).

A ray tile (sorted, so octant-pure and spatially coherent) is bounded by
an origin box x a direction box; interval arithmetic over that product
gives a conservative ray-box-vs-AABB slab for every (tile, cluster)
pair in one [tiles, C] pass.  Conservative: a cluster this test culls
has no ray in the tile whose own slab could pass, so skipping it changes
no hit.  Plain torch: it was XLA code in the JAX package.
"""

from __future__ import annotations

import torch

_PARK = 1e29   # origins at the 1e30 park exceed this
_BIG = 1e30


def tile_ray_bounds(rays8, tile: int):
    """Masked per-tile bounds of the live rays.  rays8 [8, R] f32 (rows
    0:3 origin, 3:6 direction; parked lanes carry origin 1e30).  Returns
    (o_lo, o_hi, d_lo, d_hi), each [tiles, 3]; an all-parked tile has
    o_lo > o_hi."""
    tiles = rays8.shape[1] // tile
    o = rays8[0:3].reshape(3, tiles, tile)
    d = rays8[3:6].reshape(3, tiles, tile)
    live = o.abs().amax(dim=0) < _PARK                 # [tiles, tile]
    o_lo = torch.where(live, o, _BIG).amin(dim=2).T    # [tiles, 3]
    o_hi = torch.where(live, o, -_BIG).amax(dim=2).T
    d_lo = torch.where(live, d, _BIG).amin(dim=2).T
    d_hi = torch.where(live, d, -_BIG).amax(dim=2).T
    return o_lo, o_hi, d_lo, d_hi


def _imul(a_lo, a_hi, b_lo, b_hi):
    """Interval product bounds."""
    p1 = a_lo * b_lo
    p2 = a_lo * b_hi
    p3 = a_hi * b_lo
    p4 = a_hi * b_hi
    lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    return lo, hi


def frustum_cluster_mask(rays8, cluster_min, cluster_max, tile: int,
                         best_hint=None):
    """Conservative [tiles, C] bool: may any live ray of the tile hit the
    cluster's world AABB with t in (0, t_cap)?  cluster_min/max [C, 3]
    world AABBs; ``best_hint`` an optional [R] upper bound on accepted t
    (t_max rows of a shadow pool), reduced per tile to its max."""
    o_lo, o_hi, d_lo, d_hi = tile_ray_bounds(rays8, tile)
    tiles = o_lo.shape[0]
    dev = rays8.device
    empty = o_lo[:, 0] > o_hi[:, 0]                    # all-parked tiles

    # Inverted boxes (min > max) are the never-fire convention of empty
    # slots; the normalizing slab below would fire them everywhere.
    dead_box = (cluster_min > cluster_max).any(dim=1)  # [C]

    # f32 interval arithmetic rounds to nearest, not outward: pad the
    # boxes by ~1e-5 relative so a boundary ray the exact slab accepts
    # is never culled here (overfires a hair, never underfires).
    pad = 1e-5 * (cluster_min.abs() + cluster_max.abs() + 1.0)
    cluster_min = cluster_min - pad
    cluster_max = cluster_max + pad

    if best_hint is None:
        t_cap = torch.full((tiles,), _BIG, dtype=torch.float32, device=dev)
    else:
        t_cap = torch.clamp(best_hint.reshape(tiles, tile).amax(dim=1),
                            max=_BIG)

    # A sign-straddling direction interval makes its axis unconstraining.
    t0_lo = torch.full((tiles, 1), -_BIG, dtype=torch.float32, device=dev)
    t1_hi = torch.full((tiles, 1), _BIG, dtype=torch.float32, device=dev)
    for a in range(3):
        dl = d_lo[:, a:a + 1]                          # [tiles, 1]
        dh = d_hi[:, a:a + 1]
        safe = (dl > 0.0) | (dh < 0.0)
        dl_s = torch.where(safe, dl, 1.0)
        dh_s = torch.where(safe, dh, 1.0)
        i_lo = torch.minimum(1.0 / dl_s, 1.0 / dh_s)
        i_hi = torch.maximum(1.0 / dl_s, 1.0 / dh_s)
        n_lo = cluster_min[None, :, a] - o_hi[:, a:a + 1]   # [tiles, C]
        n_hi = cluster_min[None, :, a] - o_lo[:, a:a + 1]
        f_lo = cluster_max[None, :, a] - o_hi[:, a:a + 1]
        f_hi = cluster_max[None, :, a] - o_lo[:, a:a + 1]
        na_lo, na_hi = _imul(n_lo, n_hi, i_lo, i_hi)
        fa_lo, fa_hi = _imul(f_lo, f_hi, i_lo, i_hi)
        a0_lo = torch.where(safe, torch.minimum(na_lo, fa_lo), -_BIG)
        a1_hi = torch.where(safe, torch.maximum(na_hi, fa_hi), _BIG)
        t0_lo = torch.maximum(t0_lo, a0_lo)
        t1_hi = torch.minimum(t1_hi, a1_hi)

    # Exists-ray-may-hit: a non-empty slab interval with a positive far
    # end (origin inside included) that starts below the tile's t cap.
    ok = (t0_lo <= t1_hi) & (t1_hi > 0.0) & (t0_lo < t_cap[:, None])
    return ok & ~empty[:, None] & ~dead_box[None, :]
