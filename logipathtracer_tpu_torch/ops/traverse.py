"""Scene intersection entry points (the JAX package's ``ops/traverse.py``).

Only the resident compact worklist sweep is ported: kernel K1 with its
plain-torch worklist prepass.  The BVH stack walk, the brute-force
oracle, the dense sweeps and the HBM-streamed sweeps are ROADMAP items.
"""

from __future__ import annotations

from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci


def scene_cluster_bounds(scene):
    """Per-cluster world AABBs of a device scene, computed once and kept
    on the scene (the arrays are constant for its lifetime)."""
    cached = getattr(scene, "_cluster_bounds", None)
    if cached is None:
        c = scene.cl_tris.shape[0]
        cached = ci.chunk_world_bounds(scene.cl_meta, scene.cl_aabb,
                                       scene.obj_world, c, c, 1)
        scene._cluster_bounds = cached
    return cached


def intersect_scene_sweep(scene, origin, direction, eps: float = 1e-4,
                          tile: int = 4096, backend: str = "compact",
                          t_max=None, cap: int = 128,
                          worklist: bool = True, any_hit: bool = False):
    """Closest hit via the compact worklist sweep.  origin, direction
    [R, 3] f32.  Returns (t [R] f32 — INF on miss, obj [R] i32, tri [R]
    i32; -1 where missed).  ``cap`` chooses a TPU block width and is
    ignored."""
    if backend not in ("compact", "compact_interpret"):
        raise NotImplementedError(
            f"intersect backend {backend!r} is not ported (ROADMAP Queue 2: "
            "K6, K8)")
    if not worklist:
        raise NotImplementedError(
            "the compact sweep without worklists is not ported (ROADMAP "
            "Queue 2: K7)")
    if t_max is not None or any_hit:
        raise NotImplementedError(
            "t_max / any-hit shadow queries serve NEE, which is not ported "
            "(ROADMAP Queue 1: NEE)")
    rays8, r = ci.pack_rays8(origin, direction, tile)
    inv_rows = scene.obj_world_inv[:, :3, :4].reshape(
        scene.num_objects, 12).contiguous()
    t, tri, obj = ci.cluster_intersect_compact(
        scene.cl_meta, inv_rows, scene.cl_aabb, scene.cl_tris, rays8,
        scene.obj_world, tile=tile, eps=eps,
        bounds=scene_cluster_bounds(scene))
    return t[:r], obj[:r], tri[:r]
