"""Closest-hit intersection over per-tile worklists of fired clusters
(kernel K1, csrc/compact_intersect.cu), with its plain-torch prepass.

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/
compact_intersect.py::cluster_intersect_compact(worklist=True)``
(``_compact_wl_kernel`` → ``_compact_loop``).  The function is the
same; the TPU mechanics (one-hot matmul compaction, roll-prefix ranks,
VMEM scratch) are not carried over.

Contract, per ray: visit the ray tile's fired clusters in worklist
order; transform the ray into the cluster object's space; slab-test the
cluster AABB against the running best t (``_slab_inv`` decision table,
including its ``best_t > 0`` guard); if it passes, Möller–Trumbore
against the cluster's S triangles, accepting ``t > eps`` and strictly
closer than the best, lowest slot winning ties.  Miss: t = INF,
tri = obj = -1.  Exact divides throughout (IEEE 1/0 = inf for
axis-aligned directions), as in the JAX interpret twin.

On the card: one thread per ray, a block of 256 rays inside one
worklist tile; the block stages each fired cluster's 9 x S triangle
floats (9 KB at S = 256) in shared memory, but only when some ray of
the block passes that cluster's slab.  Bound: operations — ~30 flops
per (ray, triangle) Möller–Trumbore test, one divide each; the
triangle reads are shared-memory broadcasts.  The simple design does
nothing about divergence between rays of a warp that pass different
clusters.

The worklist prepass (``chunk_world_bounds``, ``build_chunk_worklists``,
``_order_fired``) and the ``pack_rays8`` ray pack stay plain torch: they
were XLA code in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from logipathtracer_tpu_torch.ops.intersect import INF
from logipathtracer_tpu_torch.ops.kernels import _build

# Internal miss sentinel of the JAX kernel (compact_intersect.py BIG):
# best t starts here, and hits at or beyond it do not count.
BIG = 1e30

launches = 0
plain_calls = 0

SOURCE = "logipathtracer_tpu_torch/csrc/compact_intersect.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/compact_intersect.py:801"


def pack_rays8(origin, direction, tile: int):
    """Tile-padded [8, Rp] component-major ray block (traverse.py
    _pack_rays8): rows o.xyz, d.xyz, t_max (unused), pad.  Padding rays
    sit at the origin looking down +z, exactly as in the JAX package
    (they join their tile's worklist)."""
    r = origin.shape[0]
    rp = ((r + tile - 1) // tile) * tile
    rays8 = torch.zeros((8, rp), dtype=torch.float32, device=origin.device)
    rays8[5] = 1.0
    rays8[0:3, :r] = origin.T
    rays8[3:6, :r] = direction.T
    return rays8, r


def chunk_world_bounds(cl_meta, cl_aabb, obj_world, c: int, cp: int,
                       chunk: int):
    """World-space per-chunk AABBs (cluster_intersect.py:449-472): each
    cluster's 8 local corners through its object matrix, bounded, then
    ``chunk`` consecutive clusters merged; padded slots never fire."""
    dev = cl_aabb.device
    amin = cl_aabb[:, 0:3]
    amax = cl_aabb[:, 3:6]
    picks = torch.tensor([[(ci >> 2) & 1, (ci >> 1) & 1, ci & 1]
                          for ci in range(8)], dtype=torch.float32,
                         device=dev)
    corners = (amin[:, None, :] * (1.0 - picks[None])
               + amax[:, None, :] * picks[None])            # [Cp, 8, 3]
    mats = obj_world[cl_meta[:, 0].clamp(min=0).long()]      # [Cp, 4, 4]
    m = mats[:, None, :3, :3]
    wc = (m[..., 0] * corners[..., 0:1] + m[..., 1] * corners[..., 1:2]
          + m[..., 2] * corners[..., 2:3]) + mats[:, None, :3, 3]
    valid = (torch.arange(cp, device=dev) < c)[:, None]
    wmin = torch.where(valid, wc.amin(dim=1), INF)
    wmax = torch.where(valid, wc.amax(dim=1), -INF)
    return (wmin.reshape(cp // chunk, chunk, 3).amin(dim=1),
            wmax.reshape(cp // chunk, chunk, 3).amax(dim=1))


def _slab_ok(t0, t1, best):
    return (t0 <= t1) & (((t0 > 0.0) & (t0 < best))
                         | ((t0 <= 0.0) & (t1 > 0.0)))


def build_chunk_worklists(chunk_min, chunk_max, rays8, tile: int):
    """Per-tile fired-chunk lists (compact_intersect.py:587-643): slab
    every ray against every world AABB, any-reduce per ray tile, order
    front to back.  Rays go in blocks so the [NC, block] temporaries
    stay under ~48 MB.  Returns (wl [tiles, NC] i32, wn [tiles] i32)."""
    r = rays8.shape[1]
    tiles = r // tile
    nc = chunk_min.shape[0]
    inv = 1.0 / rays8[3:6]
    block = tile
    while (block * 2 <= r and r % (block * 2) == 0
           and nc * block * 2 * 4 < (48 << 20)):
        block *= 2
    fired = []
    for b0 in range(0, r, block):
        sl = slice(b0, b0 + block)
        o = rays8[0:3, sl]
        i = inv[:, sl]
        n = [(chunk_min[:, k][:, None] - o[k][None]) * i[k][None]
             for k in range(3)]
        f = [(chunk_max[:, k][:, None] - o[k][None]) * i[k][None]
             for k in range(3)]
        t0 = torch.maximum(torch.maximum(torch.minimum(n[0], f[0]),
                                         torch.minimum(n[1], f[1])),
                           torch.minimum(n[2], f[2]))
        t1 = torch.minimum(torch.minimum(torch.maximum(n[0], f[0]),
                                         torch.maximum(n[1], f[1])),
                           torch.maximum(n[2], f[2]))
        ok = _slab_ok(t0, t1, BIG)                          # [NC, block]
        fired.append(ok.reshape(nc, block // tile, tile).any(dim=2).T)
    return _order_fired(torch.cat(fired, 0), chunk_min, chunk_max, rays8,
                        tile)


def _order_fired(fired, chunk_min, chunk_max, rays8, tile: int):
    """Fired clusters first, ordered by the tile's mean direction dotted
    with the cluster centroid (stable argsort, as the JAX prepass)."""
    tiles = rays8.shape[1] // tile
    centroid = 0.5 * (chunk_min + chunk_max)                 # [NC, 3]
    md = rays8[3:6].reshape(3, tiles, tile).mean(dim=2)      # [3, T]
    key = (md[0][:, None] * centroid[:, 0][None]
           + md[1][:, None] * centroid[:, 1][None]
           + md[2][:, None] * centroid[:, 2][None])          # [T, NC]
    key = torch.where(fired, key, float("inf"))
    wl = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    wn = fired.sum(dim=1).to(torch.int32)
    return wl.contiguous(), wn.contiguous()


def _mt(lo, ld, trib):
    """Möller–Trumbore of rays [n] (components) against one cluster
    [9, S]: t [n, S], INF on a barycentric miss (cluster_intersect.py
    _mt_cluster with the exact divide)."""
    v0x, v0y, v0z = trib[0][None], trib[1][None], trib[2][None]
    e1x, e1y, e1z = trib[3][None], trib[4][None], trib[5][None]
    e2x, e2y, e2z = trib[6][None], trib[7][None], trib[8][None]
    ox, oy, oz = (x[:, None] for x in lo)
    dx, dy, dz = (x[:, None] for x in ld)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = 1.0 / (e1x * px + e1y * py + e1z * pz)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * det
    t = (e2x * qx + e2y * qy + e2z * qz) * det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    return torch.where(miss, INF, t)


def compact_wl_intersect_plain(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                               cl_tris, tile: int, eps: float):
    """Plain PyTorch version of the kernel: tiles and their worklists in
    a host loop, each visited cluster's slab and Möller–Trumbore
    vectorized over the tile's rays."""
    global plain_calls
    plain_calls += 1
    r = rays8.shape[1]
    dev = rays8.device
    s = cl_tris.shape[2]
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_obj = torch.full((r,), -1, dtype=torch.int32, device=dev)
    wl_h = wl.cpu().tolist()
    wn_h = wn.cpu().tolist()
    meta = cl_meta.cpu().tolist()
    inv_h = cl_inv.cpu()
    aabb_h = cl_aabb.cpu().tolist()
    slot_ids = torch.arange(s, device=dev)
    for ti in range(r // tile):
        sl = slice(ti * tile, (ti + 1) * tile)
        o = rays8[0:3, sl]
        d = rays8[3:6, sl]
        bt = best_t[sl]
        btri = best_tri[sl]
        bobj = best_obj[sl]
        for k in range(wn_h[ti]):
            c = wl_h[ti][k]
            obj, base = meta[c]
            m = inv_h[obj].tolist()
            lo = [m[4 * a] * o[0] + m[4 * a + 1] * o[1]
                  + m[4 * a + 2] * o[2] + m[4 * a + 3] for a in range(3)]
            ld = [m[4 * a] * d[0] + m[4 * a + 1] * d[1]
                  + m[4 * a + 2] * d[2] for a in range(3)]
            box = aabb_h[c]
            n = [(box[a] - lo[a]) * (1.0 / ld[a]) for a in range(3)]
            f = [(box[3 + a] - lo[a]) * (1.0 / ld[a]) for a in range(3)]
            t0 = torch.maximum(torch.maximum(torch.minimum(n[0], f[0]),
                                             torch.minimum(n[1], f[1])),
                               torch.minimum(n[2], f[2]))
            t1 = torch.minimum(torch.minimum(torch.maximum(n[0], f[0]),
                                             torch.maximum(n[1], f[1])),
                               torch.maximum(n[2], f[2]))
            hit = (t0 <= t1) & (((t0 > 0.0) & (t0 < bt))
                                | ((t0 <= 0.0) & (t1 > 0.0) & (bt > 0.0)))
            idx = hit.nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
            t = _mt([x[idx] for x in lo], [x[idx] for x in ld], cl_tris[c])
            t = torch.where(t > eps, t, BIG)
            tmin = t.amin(dim=1)
            slot = torch.where(t == tmin[:, None], slot_ids, s).amin(dim=1)
            upd = (tmin < BIG) & (tmin < bt[idx])
            j = idx[upd]
            bt[j] = tmin[upd]
            btri[j] = (base + slot[upd]).to(torch.int32)
            bobj[j] = obj
    t_out = torch.where(best_tri >= 0, best_t, INF)
    return t_out, best_tri, best_obj


def compact_wl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb, cl_tris,
                         tile: int, eps: float):
    """Closest hit for rays8 [8, R] (R a multiple of ``tile``) over the
    worklists wl [R/tile, C] i32 / wn [R/tile] i32.  cl_meta [C, 2] i32,
    cl_inv [O, 12] f32, cl_aabb [C, 8] f32, cl_tris [C, 9, S] f32.
    Returns (t [R] f32, tri [R] i32, obj [R] i32).  A CPU tensor takes
    the plain version, a CUDA tensor the kernel."""
    global launches
    dev = rays8.device
    if dev.type == "cpu":
        return compact_wl_intersect_plain(rays8, wl, wn, cl_meta, cl_inv,
                                          cl_aabb, cl_tris, tile, eps)
    if dev.type != "cuda":
        raise ValueError(f"compact_wl_intersect: unsupported device {dev}")
    r = rays8.shape[1]
    c, nine, s = cl_tris.shape
    threads = 256 if tile % 256 == 0 else 128
    if r % tile or tile % threads or nine != 9:
        raise ValueError(f"compact_wl_intersect: R={r} must be a multiple "
                         f"of tile={tile}, itself a multiple of 128")
    tiles = r // tile
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(wl, "wl", torch.int32, (tiles, c), dev)
    _build.require(wn, "wn", torch.int32, (tiles,), dev)
    _build.require(cl_meta, "cl_meta", torch.int32, (c, 2), dev)
    _build.require(cl_inv, "cl_inv", torch.float32, (None, 12), dev)
    _build.require(cl_aabb, "cl_aabb", torch.float32, (c, 8), dev)
    _build.require(cl_tris, "cl_tris", torch.float32, (c, 9, s), dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    obj = torch.empty(r, dtype=torch.int32, device=dev)
    lib = _build.load("compact_intersect")
    fn = lib.lpt_compact_wl_intersect
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    _build.check(fn(_build.ptr(rays8), r, _build.ptr(wl), _build.ptr(wn),
                    c, tile, _build.ptr(cl_meta), _build.ptr(cl_inv),
                    _build.ptr(cl_aabb), _build.ptr(cl_tris), s,
                    float(eps), threads, _build.ptr(t), _build.ptr(tri),
                    _build.ptr(obj), _build.stream_ptr(dev)),
                 "compact intersect kernel")
    launches += 1
    return t, tri, obj


def cluster_intersect_compact(cl_meta, cl_inv, cl_aabb, cl_tris, rays8,
                              obj_world, tile: int = 4096,
                              eps: float = 1e-4, bounds=None):
    """Worklist prepass + K1: the port of the JAX package's
    ``cluster_intersect_compact(worklist=True)``.  ``bounds`` may carry
    precomputed ``chunk_world_bounds`` (the scene's are constant)."""
    if bounds is None:
        c0 = cl_tris.shape[0]
        bounds = chunk_world_bounds(cl_meta, cl_aabb, obj_world, c0, c0, 1)
    wl, wn = build_chunk_worklists(bounds[0], bounds[1], rays8, tile)
    return compact_wl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                                cl_tris, tile, eps)


def hits_agree(ref, got, rtol: float = 2e-6, atol: float = 1e-6):
    """The acceptance rule between two closest-hit answers (the rule of
    the JAX package's tests/test_compact.py:35-43): t within
    ``rtol``/``atol``; tri and obj may differ only where t ties.  ``ref``
    and ``got`` are (t, tri, obj) arrays; raises AssertionError.
    Returns the largest |dt| over rays both answers hit."""
    import numpy as np
    tr, rr, orf = (np.asarray(x) for x in ref)
    tg, rg, og = (np.asarray(x) for x in got)
    np.testing.assert_allclose(tg, tr, rtol=rtol, atol=atol)
    tie = np.abs(tg - tr) <= rtol * np.abs(tr) + atol
    diff = (rg != rr) | (og != orf)
    assert (tie | ~diff).all(), \
        f"{int((diff & ~tie).sum())} rays differ in tri/obj off a t tie"
    hit = (tr < BIG) & (tg < BIG)
    return float(np.abs(tg[hit] - tr[hit]).max()) if hit.any() else 0.0
