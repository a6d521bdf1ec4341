"""Closest hit by a (ray tiles x chunks) sweep of a streamed scene in
per-octant front-to-back chunk order (kernel K6, csrc/stream_chunk.cu),
with its plain-torch front end.

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/
cluster_intersect.py::cluster_intersect_stream`` and its two bodies:
``_stream_kernel`` (cap = 0) and ``compact_intersect.py::
_stream_compact_kernel`` (cap > 0).  In the JAX package the kernel in
interpret mode is also the CPU twin of the worklist stream kernels
(K4, K5).

Every ray tile visits every 16-cluster chunk, in the front-to-back order
of the direction octant of the tile's first ray; a tile whose origins
are all parked (the x row only: min x >= 1e29) visits none.  Per chunk,
a test of its world AABB with the live best t, then the member clusters
c < C as in K1.  With cap > 0 the per-ray contract is K1's
(``compact_intersect.py``) and so is the design: the rays that pass a
member's slab are compacted for whole warps (csrc/closest_hit.cuh
``compact_visit``, K5's form), and the result is bit-equal to the plain
version.  The cap = 0 body differs, and the kernel and ``PlainSweep``
hold it by construction:

  * best t starts at INF, or at rays8[6] unclamped with ``has_tmax``;
  * without ``has_tmax``, t is the best t as it stands;
  * a cluster's Möller–Trumbore runs for every ray of a 128-ray
    sub-tile when some ray of it passes the cluster's slab, not only for
    the rays that pass (``_mt_subtile_update``);
  * ``any_hit`` is ignored (the closest hit gives the same t < t_max).

The kernel keeps that contract on the card (csrc/closest_hit.cuh
``subtile_visit``): one thread a ray, a block a sub-tile; the gates of
several members are published by one barrier, a member's block reaches
shared memory by cp.async only when some ray of the sub-tile passes its
slab, and every thread tests the staged slots four at a time.  Its
result is bit-equal to the plain version.

The chunk test is taken over each CUDA block's rays (128 rays with
cap = 0, else 256), not over the whole tile as on the TPU; the plain
version takes it the same way.  The two differ only where a ray misses
a chunk's world box but passes a member cluster's local box, which
rounding alone can cause.

Kernel K8 sits here too, as in the JAX package: ``dense_sweep_intersect``
(csrc/cluster_sweep.cu) replaces ``cluster_intersect_pallas``
(``_kernel`` → ``_mt_subtile_update``), the dense resident sweep of
``intersect="sweep"``: every cluster in ``cl_order[octant of the tile's
first ray]``, with the cap = 0 body's per-ray contract above (no chunks,
no tile skipped), on the same sub-tile visit, bit-equal to its plain
version.  It counts as ``dense_sweep``, K6 as ``octant_chunk``
(``_build.COUNTS``).  ``cluster_intersect_jnp`` is the port of the JAX
package's jnp twin (``intersect="sweep_jnp"``): plain torch, every
cluster in index order, every ray tested, no slab.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.intersect import INF
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci

# 128-ray sub-tile of the cap = 0 body (cluster_intersect.py:171-194).
SUBTILE = 128

SOURCE = "logipathtracer_tpu_torch/csrc/stream_chunk.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/cluster_intersect.py:478"
REPLACES_CAP = "logipathtracer_tpu/ops/pallas/compact_intersect.py:400"
# Kernel K8 (the dense resident sweep).
SWEEP_SOURCE = "logipathtracer_tpu_torch/csrc/cluster_sweep.cu"
SWEEP_REPLACES = "logipathtracer_tpu/ops/pallas/cluster_intersect.py:265"


def octant_chunk_order(chunk_min, chunk_max):
    """[8, NC] i32 per-octant front-to-back chunk order
    (cluster_intersect.py:523-530): chunks by their centroid dotted with
    the octant's sign vector, stable; a chunk with a non-finite centroid
    sorts last."""
    centroid = 0.5 * (chunk_min + chunk_max)                  # [NC, 3]
    signs = torch.tensor([[1.0 if oc & 4 else -1.0, 1.0 if oc & 2 else -1.0,
                           1.0 if oc & 1 else -1.0] for oc in range(8)],
                         dtype=torch.float32, device=chunk_min.device)
    key = (signs[:, 0:1] * centroid[:, 0][None]
           + signs[:, 1:2] * centroid[:, 1][None]
           + signs[:, 2:3] * centroid[:, 2][None])            # [8, NC]
    key = torch.where(torch.isfinite(centroid).all(dim=1)[None], key, INF)
    return torch.argsort(key, dim=1, stable=True).to(torch.int32).contiguous()


def tile_front(rays8, tile: int):
    """(oct [tiles] i32, live [tiles] i32): each tile's direction octant
    from its first ray (cluster_intersect.py:531-534) and whether some
    origin x of the tile is below the 1e29 park (:539-540)."""
    live = (rays8[0].reshape(-1, tile).amin(dim=1) < 1e29).to(torch.int32)
    return ci.tile_octants(rays8, tile), live.contiguous()


def _threads(r: int, tile: int, cap: int) -> int:
    threads = ci._block_threads(r, tile, "octant_chunk_intersect")
    return threads if cap else SUBTILE


def octant_chunk_intersect_plain(rays8, oct_, order, live, chunk_aabb,
                                 cl_meta, cl_inv, cl_aabb, cl_tris,
                                 tile: int, chunk: int, eps: float,
                                 cap: int = 0, has_tmax: bool = False,
                                 any_hit: bool = False):
    """Plain PyTorch version of K6: tiles, chunks and member clusters in
    host loops, each visit vectorized over the tile's rays."""
    _build.plain("octant_chunk")
    r = rays8.shape[1]
    block = _threads(r, tile, cap)
    best0 = (ci.best_init(rays8, has_tmax) if cap
             else _sweep_best0(rays8, has_tmax))
    sweep = ci.PlainSweep(rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps,
                          best0)
    boxes = chunk_aabb.cpu().tolist()
    order_h = order.cpu().tolist()
    for ti, (oc, lv) in enumerate(zip(oct_.cpu().tolist(),
                                      live.cpu().tolist())):
        if not lv:
            continue
        sl = slice(ti * tile, (ti + 1) * tile)
        for jc in order_h[oc]:
            ci.visit_chunk_plain(sweep, sl, jc, boxes[jc], chunk,
                                 cl_tris.shape[0], block,
                                 any_hit=bool(cap and any_hit),
                                 subtile=0 if cap else SUBTILE)
    return sweep.result(masked=bool(cap or has_tmax))


def octant_chunk_intersect(rays8, oct_, order, live, chunk_aabb, cl_meta,
                           cl_inv, cl_aabb, cl_tris, tile: int, chunk: int,
                           eps: float, cap: int = 0, has_tmax: bool = False,
                           any_hit: bool = False):
    """Kernel K6: closest hit for rays8 [8, R] (R a multiple of ``tile``)
    sweeping every ``chunk``-cluster chunk (world AABBs chunk_aabb
    [NC, 6]) in the order order[oct_[tile]] ([8, NC] i32, oct_ [tiles]
    i32), skipping tiles with live == 0 ([tiles] i32).  ``cap`` 0 takes
    the cap = 0 body (module docstring), > 0 K1's contract; the TPU
    block width it names is not used.  A CPU tensor takes the plain
    version, a CUDA tensor the kernel."""
    dev = rays8.device
    args = (rays8, oct_, order, live, chunk_aabb, cl_meta, cl_inv, cl_aabb,
            cl_tris, tile, chunk, eps, cap, has_tmax, any_hit)
    if dev.type == "cpu":
        return octant_chunk_intersect_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"octant_chunk_intersect: unsupported device {dev}")
    r = rays8.shape[1]
    threads = _threads(r, tile, cap)
    c, s = ci.require_scene(cl_meta, cl_inv, cl_aabb, cl_tris, dev,
                            stream=True)
    nc = -(-c // chunk)
    tiles = r // tile
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(oct_, "oct", torch.int32, (tiles,), dev)
    _build.require(order, "order", torch.int32, (8, nc), dev)
    _build.require(live, "live", torch.int32, (tiles,), dev)
    _build.require(chunk_aabb, "chunk_aabb", torch.float32, (nc, 6), dev)
    t, tri, obj = ci._outputs(r, dev)
    _build.launch("stream_chunk", "lpt_octant_chunk_intersect",
                  rays8, r, oct_, order, live, nc, tile, chunk, c,
                  chunk_aabb, cl_meta, cl_inv, cl_aabb, cl_tris, s,
                  float(eps), threads, not cap, bool(has_tmax),
                  bool(any_hit), t, tri, obj, _build.stream_ptr(dev))
    _build.launched("octant_chunk", ("cap" if cap else "cap0") + "/"
                    + ci._mode(has_tmax, any_hit))
    return t, tri, obj


def cluster_intersect_stream(cl_meta, cl_inv, cl_aabb, cl_tris, obj_world,
                             rays8, tile: int = 2048, chunk: int = 16,
                             eps: float = 1e-4, has_tmax: bool = False,
                             cap: int = 0, any_hit: bool = False,
                             bounds=None, order=None):
    """Front end + K6: the port of the JAX package's
    ``cluster_intersect_stream``.  ``bounds`` may carry precomputed
    ``padded_chunk_bounds`` and ``order`` their ``octant_chunk_order``
    (both are constant for a scene)."""
    if bounds is None:
        bounds = ci.padded_chunk_bounds(cl_meta, cl_aabb, obj_world, chunk)
    if order is None:
        order = octant_chunk_order(*bounds)
    oct_, live = tile_front(rays8, tile)
    chunk_aabb = torch.cat(bounds, dim=1).contiguous()
    return octant_chunk_intersect(rays8, oct_, order, live, chunk_aabb,
                                  cl_meta, cl_inv, cl_aabb, cl_tris, tile,
                                  chunk, eps, cap=cap, has_tmax=has_tmax,
                                  any_hit=any_hit)


def _sweep_best0(rays8, has_tmax: bool):
    """The cap = 0 body's initial best t: rays8[6] unclamped with
    ``has_tmax``, else INF."""
    if has_tmax:
        return rays8[6].clone()
    return torch.full((rays8.shape[1],), INF, dtype=torch.float32,
                      device=rays8.device)


def dense_sweep_intersect_plain(rays8, oct_, order, cl_meta, cl_inv, cl_aabb,
                                cl_tris, tile: int, eps: float,
                                has_tmax: bool = False):
    """Plain PyTorch version of K8 (``compact_intersect.order_sweep_plain``
    with the cap = 0 body's contract and 128-ray sub-tiles)."""
    _build.plain("dense_sweep")
    return ci.order_sweep_plain(rays8, oct_, order, cl_meta, cl_inv, cl_aabb,
                                cl_tris, tile, eps,
                                _sweep_best0(rays8, has_tmax),
                                subtile=SUBTILE, masked=has_tmax)


def dense_sweep_intersect(rays8, oct_, order, cl_meta, cl_inv, cl_aabb,
                          cl_tris, tile: int, eps: float,
                          has_tmax: bool = False):
    """Kernel K8: closest hit for rays8 [8, R] (R a multiple of ``tile``,
    itself of 128) visiting every cluster in order[oct_[tile]] with the
    cap = 0 body's contract (module docstring).  A CPU tensor takes the
    plain version, a CUDA tensor the kernel (S a multiple of 4, cl_tris
    16-byte aligned)."""
    dev = rays8.device
    if dev.type == "cpu":
        return dense_sweep_intersect_plain(rays8, oct_, order, cl_meta, cl_inv,
                                           cl_aabb, cl_tris, tile, eps,
                                           has_tmax)
    if dev.type != "cuda":
        raise ValueError(f"dense_sweep_intersect: unsupported device {dev}")
    ci._block_threads(rays8.shape[1], tile, "dense_sweep_intersect")
    t, tri, obj = ci.launch_order(rays8, oct_, order, cl_meta, cl_inv,
                                  cl_aabb, cl_tris, tile, eps, SUBTILE, True,
                                  has_tmax, False)
    _build.launched("dense_sweep", ci._mode(has_tmax, False))
    return t, tri, obj


def cluster_intersect_pallas(cl_meta, cl_inv, cl_order, cl_aabb, cl_tris,
                             rays8, tile: int = 1024, eps: float = 1e-4,
                             has_tmax: bool = False):
    """Tile octants + K8: the port of the JAX package's
    ``cluster_intersect_pallas`` (same arguments; ``interpret`` has no
    counterpart).  Returns (t [R], tri [R] i32, obj [R] i32)."""
    return dense_sweep_intersect(rays8, ci.tile_octants(rays8, tile),
                                 cl_order, cl_meta, cl_inv, cl_aabb, cl_tris,
                                 tile, eps, has_tmax=has_tmax)


def cluster_intersect_jnp(cl_meta, cl_inv, cl_aabb, cl_tris, rays8,
                          eps: float = 1e-4, t_max=None):
    """The JAX package's jnp twin of the sweep (cluster_intersect.py:
    608-655) in plain torch: every cluster in index order against every
    ray, no slab test; accept t > eps strictly closer than the best,
    lowest slot on ties.  Best t starts at INF or ``t_max`` [R]; with
    ``t_max`` the result t is INF where no hit was accepted.  Rays go
    ``ci.MT_RAYS`` at a time."""
    r = rays8.shape[1]
    dev = rays8.device
    m = cl_inv
    o, d = rays8[0:3], rays8[3:6]
    lo = [m[:, 4 * a, None] * o[0] + m[:, 4 * a + 1, None] * o[1]
          + m[:, 4 * a + 2, None] * o[2] + m[:, 4 * a + 3, None]
          for a in range(3)]                               # 3 x [O, R]
    ld = [m[:, 4 * a, None] * d[0] + m[:, 4 * a + 1, None] * d[1]
          + m[:, 4 * a + 2, None] * d[2] for a in range(3)]
    best_t = (torch.full((r,), INF, dtype=torch.float32, device=dev)
              if t_max is None else t_max.clone())
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_obj = torch.full((r,), -1, dtype=torch.int32, device=dev)
    s = cl_tris.shape[2]
    slot_ids = torch.arange(s, device=dev)
    for c, (obj, base) in enumerate(cl_meta.cpu().tolist()):
        for part in torch.arange(r, device=dev).split(ci.MT_RAYS):
            t = ci._mt([x[obj, part] for x in lo], [x[obj, part] for x in ld],
                       cl_tris[c])
            ok = (t > eps) & (t < best_t[part, None])
            t = torch.where(ok, t, INF)
            tmin = t.amin(dim=1)
            is_min = (t == tmin[:, None]) & (tmin[:, None] < INF)
            slot = torch.where(is_min, slot_ids, s).amin(dim=1)
            upd = tmin < best_t[part]
            j = part[upd]
            best_t[j] = tmin[upd]
            best_tri[j] = (base + slot[upd]).to(torch.int32)
            best_obj[j] = obj
    if t_max is not None:
        best_t = torch.where(best_tri >= 0, best_t, INF)
    return best_t, best_tri, best_obj
