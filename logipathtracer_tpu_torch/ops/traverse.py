"""Scene intersection entry points (the JAX package's ``ops/traverse.py``).

Ported: the resident compact worklist sweep (kernel K1) and the three
sweeps of scenes beyond the resident budget, which stream cluster
blocks: the frustum cluster worklists (K4), the chunk worklists (K5) and
the (tiles x chunks) octant sweep (K6).  Each runs its plain-torch
prepass, then its kernel on CUDA tensors or its plain version on CPU
ones, for closest-hit queries and for the t_max / any-hit shadow
queries of next-event estimation.  The BVH stack walk, the brute-force
oracle and the resident sweeps without worklists (K7, K8) are ROADMAP
items.

``cm`` (the JAX package's component-major [3, R] rays) is accepted by
the streamed entry points as there; ``cap`` and ``nbuf`` choose TPU
block widths and ring depths and are ignored.
"""

from __future__ import annotations

from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4


def _scene_cache(scene, key, make):
    """A per-scene constant (bounds, orders), computed once and kept on
    the scene: its arrays do not change for its lifetime."""
    cache = scene.__dict__.setdefault("_derived", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def scene_cluster_bounds(scene):
    """Per-cluster world AABBs of a device scene ([C, 3] min, max)."""
    def make():
        c = scene.cl_tris.shape[0]
        return ci.chunk_world_bounds(scene.cl_meta, scene.cl_aabb,
                                     scene.obj_world, c, c, 1)
    return _scene_cache(scene, "cluster_bounds", make)


def scene_chunk_bounds(scene, chunk: int):
    """World AABBs of the scene's ``chunk``-cluster chunks, the cluster
    tables padded to a chunk multiple ([NC, 3] min, max)."""
    return _scene_cache(scene, ("chunk_bounds", chunk), lambda:
                        ci.padded_chunk_bounds(scene.cl_meta, scene.cl_aabb,
                                               scene.obj_world, chunk))


def _inv_rows(scene):
    return _scene_cache(scene, "inv_rows", lambda: scene.obj_world_inv[
        :, :3, :4].reshape(scene.num_objects, 12).contiguous())


def _rays(origin, direction, tile: int, t_max, cm: bool):
    if cm:
        origin, direction = origin.T, direction.T
    return ci.pack_rays8(origin, direction, tile, t_max=t_max)


def intersect_scene_sweep(scene, origin, direction, eps: float = 1e-4,
                          tile: int = 4096, backend: str = "compact",
                          t_max=None, cap: int = 128,
                          worklist: bool = True, any_hit: bool = False):
    """Closest hit via the compact worklist sweep.  origin, direction
    [R, 3] f32.  Returns (t [R] f32 — INF on miss, obj [R] i32, tri [R]
    i32; -1 where missed).  ``t_max`` [R] f32 counts only hits closer
    than it; ``any_hit`` (with ``t_max``) stops a ray at its first such
    hit, when only the predicate t < t_max holds (blocked rays return
    t = -1e30).  ``cap`` chooses a TPU block width and is ignored."""
    if backend not in ("compact", "compact_interpret"):
        raise NotImplementedError(
            f"intersect backend {backend!r} is not ported (ROADMAP Queue 2: "
            "K8)")
    if not worklist:
        raise NotImplementedError(
            "the compact sweep without worklists is not ported (ROADMAP "
            "Queue 2: K7)")
    has_tmax = t_max is not None
    rays8, r = ci.pack_rays8(origin, direction, tile, t_max=t_max)
    t, tri, obj = ci.cluster_intersect_compact(
        scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris, rays8,
        scene.obj_world, tile=tile, eps=eps,
        bounds=scene_cluster_bounds(scene), has_tmax=has_tmax,
        any_hit=any_hit and has_tmax)
    return t[:r], obj[:r], tri[:r]


def intersect_scene_stream(scene, origin, direction, eps: float = 1e-4,
                           tile: int = 2048, chunk: int = 16,
                           backend: str = "pallas", t_max=None,
                           cap: int = 0, cm: bool = False,
                           any_hit: bool = False):
    """Closest hit via the (tiles x chunks) streamed sweep, kernel K6.
    Same contract as intersect_scene_sweep; ``cap`` 0 takes the cap = 0
    body (best t from INF, the triangle test per 128-ray sub-tile,
    ``any_hit`` ignored), > 0 K1's per-ray contract.  ``backend``
    "pallas" or "interpret" (the JAX package's TPU kernel or its
    interpreter) both mean K6 here."""
    if backend not in ("pallas", "interpret"):
        raise ValueError(f"unknown stream backend {backend!r}")
    has_tmax = t_max is not None
    rays8, r = _rays(origin, direction, tile, t_max, cm)
    bounds = scene_chunk_bounds(scene, chunk)
    order = _scene_cache(scene, ("chunk_order", chunk),
                         lambda: k6.octant_chunk_order(*bounds))
    t, tri, obj = k6.cluster_intersect_stream(
        scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris,
        scene.obj_world, rays8, tile=tile, chunk=chunk, eps=eps,
        has_tmax=has_tmax, cap=cap, any_hit=any_hit and has_tmax,
        bounds=bounds, order=order)
    return t[:r], obj[:r], tri[:r]


def intersect_scene_worklist(scene, origin, direction, eps: float = 1e-4,
                             tile: int = 4096, chunk: int = 16,
                             t_max=None, cap: int = 128,
                             cm: bool = False, any_hit: bool = False):
    """Closest hit via the chunk worklist streamed sweep, kernel K5
    (``stream_granularity="chunk"``).  Same contract as
    intersect_scene_sweep."""
    has_tmax = t_max is not None
    rays8, r = _rays(origin, direction, tile, t_max, cm)
    t, tri, obj = ci.cluster_intersect_worklist(
        scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris,
        scene.obj_world, rays8, tile=tile, chunk=chunk, eps=eps,
        has_tmax=has_tmax, any_hit=any_hit and has_tmax,
        bounds=scene_chunk_bounds(scene, chunk))
    return t[:r], obj[:r], tri[:r]


def intersect_scene_cluster_wl(scene, origin, direction, eps: float = 1e-4,
                               tile: int = 4096, t_max=None, cap: int = 32,
                               cm: bool = False, any_hit: bool = False,
                               nbuf: int = 4, chunk_gate: int = 0):
    """Closest hit via the frustum cluster worklist streamed sweep,
    kernel K4 — the default intersect of scenes beyond the resident
    budget (``stream_granularity="cluster"``).  Same contract as
    intersect_scene_sweep."""
    has_tmax = t_max is not None
    rays8, r = _rays(origin, direction, tile, t_max, cm)
    t, tri, obj = k4.cluster_intersect_stream_cl(
        scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris,
        scene.obj_world, rays8, tile=tile, eps=eps, has_tmax=has_tmax,
        any_hit=any_hit and has_tmax, chunk_gate=chunk_gate,
        bounds=scene_cluster_bounds(scene))
    return t[:r], obj[:r], tri[:r]

