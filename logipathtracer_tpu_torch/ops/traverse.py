"""Scene intersection entry points (the JAX package's ``ops/traverse.py``).

Every entry point of the JAX module is ported.  The cluster sweeps run
their plain-torch front end, then their kernel on CUDA tensors or its
plain version on CPU ones, for closest-hit queries and for the t_max /
any-hit shadow queries of next-event estimation:

  * resident scenes (``intersect_scene_sweep``): the compact worklist
    sweep (K1, with its per-ray prepass), the compact sweep without
    worklists (K7, every cluster in per-octant order), the dense sweep
    masked per 128-ray sub-tile (K8) and the jnp twin (plain torch);
  * scenes beyond the resident budget, which stream cluster blocks: the
    frustum cluster worklists (K4), the chunk worklists (K5) and the
    (tiles x chunks) octant sweep (K6).

The two-level BVH stack walk (``intersect_scene``) and the brute-force
oracle (``intersect_bruteforce``) were XLA code in the JAX package and
are plain torch here: the walk's loop test ``any(sp > 0)`` is one host
read per iteration, as the JAX ``while_loop`` tests it once per trip.

``cm`` (the JAX package's component-major [3, R] rays) is accepted by
the streamed entry points as there; ``cap`` and ``nbuf`` choose TPU
block widths and ring depths and are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from logipathtracer_tpu_torch.ops.intersect import (INF, matvec3,
                                                    ray_aabb_test,
                                                    ray_triangle)
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


def scene_cluster_groups(scene):
    """The 32-slot groups of a device scene's clusters that K1 and K4
    take (``compact_intersect.cluster_groups``: boxes [C, G, 8], counts
    [C])."""
    return _scene_cache(scene, "cluster_groups", lambda: ci.cluster_groups(
        scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris))


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
                          worklist: bool = True, any_hit: bool = False,
                          fired=None):
    """Closest hit via a resident cluster sweep.  origin, direction
    [R, 3] f32.  Returns (t [R] f32 — INF on miss, obj [R] i32, tri [R]
    i32; -1 where missed).  ``t_max`` [R] f32 counts only hits closer
    than it.  ``backend`` "compact" / "compact_interpret" is K1 with
    ``worklist`` (its per-ray prepass first), K7 without; there
    ``any_hit`` (with ``t_max``) stops a ray at its first such hit, when
    only the predicate t < t_max holds (blocked rays return t = -1e30).
    "pallas" / "interpret" is K8 and "jnp" the jnp twin; both answer
    closest-hit and ignore ``any_hit`` (the same t < t_max predicate).
    ``fired`` (K1 with ``worklist``): a one-element int64 tensor the
    prepass's fired (tile, chunk) pairs are added into.  ``cap`` chooses
    a TPU block width and is ignored."""
    has_tmax = t_max is not None
    rays8, r = ci.pack_rays8(origin, direction, tile, t_max=t_max)
    tables = (scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris)
    if backend in ("compact", "compact_interpret"):
        t, tri, obj = ci.cluster_intersect_compact(
            *tables, rays8, scene.obj_world, tile=tile, eps=eps,
            bounds=scene_cluster_bounds(scene) if worklist else None,
            has_tmax=has_tmax, any_hit=any_hit and has_tmax,
            worklist=worklist, cl_order=scene.cl_order,
            groups=scene_cluster_groups(scene)
            if worklist and rays8.is_cuda else None, fired=fired)
    elif backend in ("pallas", "interpret"):
        t, tri, obj = k6.cluster_intersect_pallas(
            scene.cl_meta, _inv_rows(scene), scene.cl_order, scene.cl_aabb,
            scene.cl_tris, rays8, tile=tile, eps=eps, has_tmax=has_tmax)
    elif backend == "jnp":
        t, tri, obj = k6.cluster_intersect_jnp(
            *tables, rays8, eps=eps, t_max=rays8[6] if has_tmax else None)
    else:
        raise ValueError(f"unknown sweep backend {backend!r}")
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
                               nbuf: int = 4, chunk_gate: int = 0,
                               fired=None):
    """Closest hit via the frustum cluster worklist streamed sweep,
    kernel K4 — the default intersect of scenes beyond the resident
    budget (``stream_granularity="cluster"``).  Same contract as
    intersect_scene_sweep; ``fired`` takes the prepass's fired (tile,
    cluster) pairs."""
    has_tmax = t_max is not None
    rays8, r = _rays(origin, direction, tile, t_max, cm)
    t, tri, obj = k4.cluster_intersect_stream_cl(
        scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris,
        scene.obj_world, rays8, tile=tile, eps=eps, has_tmax=has_tmax,
        any_hit=any_hit and has_tmax, chunk_gate=chunk_gate,
        bounds=scene_cluster_bounds(scene),
        groups=scene_cluster_groups(scene) if rays8.is_cuda else None,
        fired=fired)
    return t[:r], obj[:r], tri[:r]


def _padded_inverses(scene):
    """[O+1, 3, 4] f32: an identity row 0 (world-space nodes), then each
    object's inverse world rows (traverse.py:144-148)."""
    def make():
        inv = scene.obj_world_inv[:, :3, :4]
        ident = torch.eye(3, 4, dtype=inv.dtype, device=inv.device)[None]
        return torch.cat([ident, inv], 0)
    return _scene_cache(scene, "padded_inverses", make)


def _local_ray(inv_rows, origin, direction):
    """World rays through gathered [R, 3, 4] inverse rows (traverse.py
    _local_ray); the direction is not normalized."""
    return (matvec3(inv_rows[:, :, :3], origin) + inv_rows[:, :, 3],
            matvec3(inv_rows[:, :, :3], direction))


def intersect_scene(scene, origin, direction, eps: float = 1e-4,
                    t_max=None, any_hit: bool = False):
    """Closest hit by the two-level BVH stack walk (traverse.py:51-141):
    both BVH levels fused into one node array, one [R, S] stack of node
    ids (S = scene.max_stack) walked by every ray in lockstep, a node's
    AABB tested in the local space of its object, leaves of at most
    ``scene.leaf_width`` triangles.  origin, direction [R, 3] f32;
    ``t_max`` [R] counts only hits closer than it.  ``any_hit`` is
    ignored: the closest hit gives the same t < t_max predicate.  Returns
    (t [R] — INF on miss, obj [R] i32, tri [R] i32; -1 where missed).
    Plain torch on either device; one host read per loop trip."""
    r = origin.shape[0]
    dev = origin.device
    s = scene.max_stack
    meta_all = scene.fused_meta
    inv_all = _padded_inverses(scene)
    vtx = scene.vtx_pos
    lanes = torch.arange(r, device=dev)
    stack = torch.zeros((r, s), dtype=torch.int32, device=dev)
    sp = torch.ones(r, dtype=torch.int32, device=dev)  # root pre-pushed
    best_t = (torch.full((r,), INF, dtype=torch.float32, device=dev)
              if t_max is None else t_max.clone())
    best_obj = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)

    while bool((sp > 0).any()):
        live = sp > 0
        top = torch.clamp(sp - 1, min=0).long()
        idx = stack[lanes, top].long()
        sp = torch.where(live, sp - 1, sp)
        meta = meta_all[idx]                                  # [R, 4]
        kind, a, b = meta[:, 0], meta[:, 1], meta[:, 2]
        is_inner = live & (kind == 0)
        is_leaf = live & (kind == 1)

        # Inner: test both children in their objects' spaces, push the
        # survivors (a then b).  A leaf's a/b are triangle ids: masked.
        for child in (a, b):
            child = torch.where(is_inner, child, 0).long()
            inv = inv_all[meta_all[child, 3].long() + 1]
            o_loc, d_loc = _local_ray(inv, origin, direction)
            hit = ray_aabb_test(o_loc, 1.0 / d_loc, scene.fused_min[child],
                                scene.fused_max[child], best_t)
            push = is_inner & hit
            slot = torch.clamp(sp, max=s - 1).long()
            cur = stack[lanes, slot]
            stack[lanes, slot] = torch.where(push, child.to(torch.int32),
                                             cur)
            sp = sp + push.to(torch.int32)

        # Leaf: a fixed-width masked loop over its triangles [a, b).
        lobj = meta[:, 3]
        inv = inv_all[torch.where(is_leaf, lobj + 1, 0).long()]
        o_loc, d_loc = _local_ray(inv, origin, direction)
        for k in range(scene.leaf_width):
            tri = a + k
            valid = is_leaf & (tri < b)
            vbase = 3 * torch.where(valid, tri, 0).long()
            t = ray_triangle(o_loc, d_loc, vtx[vbase], vtx[vbase + 1],
                             vtx[vbase + 2])
            accept = valid & (t > eps) & (t < best_t)
            best_t = torch.where(accept, t, best_t)
            best_obj = torch.where(accept, lobj, best_obj)
            best_tri = torch.where(accept, tri, best_tri)

    if t_max is not None:
        best_t = torch.where(best_tri >= 0, best_t, INF)
    return best_t, best_obj, best_tri


def intersect_bruteforce(scene, origin, direction, eps: float = 1e-4,
                         chunk: int = 4096):
    """Oracle (traverse.py:272-313): every triangle of every object, no
    BVH; the owning object of each triangle comes from the leaf
    metadata.  O(R x T): tiny scenes only."""
    meta = np.asarray(scene.fused_meta.cpu())
    t_total = int(scene.vtx_pos.shape[0] // 3)
    tri_obj = np.zeros(t_total, np.int32)
    leaves = meta[meta[:, 0] == 1]
    for a, b, obj in zip(leaves[:, 1], leaves[:, 2], leaves[:, 3]):
        tri_obj[a:b] = obj
    dev = origin.device
    tri_obj = torch.from_numpy(tri_obj).to(dev)
    inv_all = _padded_inverses(scene)
    vtx = scene.vtx_pos.reshape(-1, 3, 3)
    r = origin.shape[0]
    best_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    best_obj = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    for start in range(0, t_total, chunk):
        end = min(start + chunk, t_total)
        objs = tri_obj[start:end]
        inv = inv_all[objs.long() + 1]                         # [C, 3, 4]
        o_loc = (matvec3(inv[None, :, :, :3], origin[:, None, :])
                 + inv[None, :, :, 3])
        d_loc = matvec3(inv[None, :, :, :3], direction[:, None, :])
        tri = vtx[start:end]
        t = ray_triangle(o_loc, d_loc, tri[None, :, 0], tri[None, :, 1],
                         tri[None, :, 2])                      # [R, C]
        t = torch.where(t > eps, t, INF)
        tk, k = t.min(dim=1)
        accept = tk < best_t
        best_t = torch.where(accept, tk, best_t)
        best_obj = torch.where(accept, objs[k], best_obj)
        best_tri = torch.where(accept, (start + k).to(torch.int32), best_tri)
    return best_t, best_obj, best_tri
