"""Closest hit over per-tile frustum fired-cluster lists of a streamed
scene (kernel K4, csrc/stream_cluster.cu), with its plain-torch prepass.

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/
stream_cluster.py::cluster_intersect_stream_cl`` (``_cluster_wl_kernel``),
the default intersect of scenes beyond the resident budget
(``stream_granularity="cluster"``).  Its per-ray function is K1's,
shadow modes included (``compact_intersect.py``); only the worklist
differs.  The prepass ``build_cluster_worklists`` fires, per ray tile,
the clusters of the conservative interval-arithmetic frustum mask
(``ops/frustum.py``), optionally ANDed with the per-ray slab of
``chunk_gate``-cluster chunks, and orders them front to back with K1's
stable ``_order_fired``.  A cluster the mask culls has no ray of the
tile whose slab could pass, so the culls change no hit.

On the card K4 runs the compacted visit (csrc/closest_hit.cuh
``compact_visit``; the TPU kernel's own design, its hit rays compacted
before the triangle tests): per listed cluster the rays of a block that
pass its slab are queued and whole warps test one queued ray each; a
cluster no ray of the block passes is never read.  A warp tests the
queued ray against the boxes of the cluster's 32-slot groups first
(``compact_intersect.cluster_groups``, as K1 does) and runs the
triangle test only on the groups it passes.  See the source's note.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.frustum import frustum_cluster_mask
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci

SOURCE = "logipathtracer_tpu_torch/csrc/stream_cluster.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/stream_cluster.py:218"


def build_cluster_worklists(wmin, wmax, rays8, tile: int,
                            has_tmax: bool = False, chunk_gate: int = 0):
    """Per-tile fired-cluster lists, front to back
    (stream_cluster.py:53-135).  wmin/wmax [C, 3] per-cluster world
    AABBs.  The fired set is the frustum mask (bounded by the tile's
    largest t_max with ``has_tmax``); with ``chunk_gate`` = k > 0 it is
    also ANDed with the per-ray slab of k-cluster chunk AABBs.  Returns
    (wl [tiles, C] i32, wn [tiles] i32); all-parked tiles get wn = 0."""
    c = wmin.shape[0]
    fired = frustum_cluster_mask(rays8, wmin, wmax, tile,
                                 best_hint=rays8[6] if has_tmax else None)
    if chunk_gate:
        cp = -(-c // chunk_gate) * chunk_gate
        pmin = torch.cat([wmin, wmin.new_full((cp - c, 3), ci.BIG)])
        pmax = torch.cat([wmax, wmax.new_full((cp - c, 3), -ci.BIG)])
        cmin = pmin.reshape(-1, chunk_gate, 3).amin(dim=1)
        cmax = pmax.reshape(-1, chunk_gate, 3).amax(dim=1)
        cfired = ci.fired_chunks(cmin, cmax, rays8, tile, has_tmax)
        fired = fired & cfired.repeat_interleave(chunk_gate, dim=1)[:, :c]
    return ci._order_fired(fired, wmin, wmax, rays8, tile)


def stream_cl_intersect_plain(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                              cl_tris, tile: int, eps: float,
                              has_tmax: bool = False, any_hit: bool = False):
    """Plain PyTorch version of K4: tiles and their fired clusters in a
    host loop, each visit vectorized over the tile's rays."""
    _build.plain("stream_cluster")
    sweep = ci.PlainSweep(rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps,
                          ci.best_init(rays8, has_tmax))
    wl_h = wl.cpu().tolist()
    for ti, n in enumerate(wn.cpu().tolist()):
        sl = slice(ti * tile, (ti + 1) * tile)
        for c in wl_h[ti][:n]:
            sweep.visit(sl, c, any_hit=any_hit)
    return sweep.result()


def stream_cl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb, cl_tris,
                        tile: int, eps: float, has_tmax: bool = False,
                        any_hit: bool = False, groups=None):
    """Kernel K4: closest hit for rays8 [8, R] (R a multiple of ``tile``)
    over the fired-cluster lists wl [R/tile, C] i32 / wn [R/tile] i32;
    the cluster tables and modes are K1's.  ``groups``: the tables'
    ``compact_intersect.cluster_groups``, built here when None (a scene
    keeps its own, ops/traverse.py ``scene_cluster_groups``).  Returns
    (t [R] f32, tri [R] i32, obj [R] i32).  A CPU tensor takes the plain
    version, a CUDA tensor the kernel."""
    dev = rays8.device
    if dev.type == "cpu":
        return stream_cl_intersect_plain(rays8, wl, wn, cl_meta, cl_inv,
                                         cl_aabb, cl_tris, tile, eps,
                                         has_tmax, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"stream_cl_intersect: unsupported device {dev}")
    r = rays8.shape[1]
    threads = ci._block_threads(r, tile, "stream_cl_intersect")
    c, s = ci.require_scene(cl_meta, cl_inv, cl_aabb, cl_tris, dev,
                            stream=True)
    gbox, gn, g = ci.require_groups(groups, cl_meta, cl_inv, cl_aabb,
                                    cl_tris, dev)
    tiles = r // tile
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(wl, "wl", torch.int32, (tiles, c), dev)
    _build.require(wn, "wn", torch.int32, (tiles,), dev)
    t, tri, obj = ci._outputs(r, dev)
    _build.launch("stream_cluster", "lpt_stream_cluster_intersect",
                  rays8, r, wl, wn, c, tile, cl_meta, cl_inv, cl_aabb,
                  cl_tris, s, gbox, gn, g, float(eps), threads,
                  bool(has_tmax), bool(any_hit), t, tri, obj,
                  _build.stream_ptr(dev))
    _build.launched("stream_cluster", ci._mode(has_tmax, any_hit))
    return t, tri, obj


def cluster_intersect_stream_cl(cl_meta, cl_inv, cl_aabb, cl_tris,
                                obj_world, rays8, tile: int = 4096,
                                eps: float = 1e-4, has_tmax: bool = False,
                                any_hit: bool = False, chunk_gate: int = 0,
                                bounds=None, groups=None, fired=None):
    """Frustum prepass + K4: the port of the JAX package's
    ``cluster_intersect_stream_cl``.  ``bounds`` may carry precomputed
    per-cluster ``chunk_world_bounds`` and ``groups`` the tables'
    ``compact_intersect.cluster_groups`` (the scene's are constant).
    ``fired``, a one-element int64 tensor, takes the sum of the
    prepass's ``wn`` (the (tile, cluster) pairs it fires), on the
    device."""
    if bounds is None:
        c = cl_tris.shape[0]
        bounds = ci.chunk_world_bounds(cl_meta, cl_aabb, obj_world, c, c, 1)
    wl, wn = build_cluster_worklists(bounds[0], bounds[1], rays8, tile,
                                     has_tmax=has_tmax,
                                     chunk_gate=chunk_gate)
    if fired is not None:
        fired.add_(wn.sum())
    return stream_cl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                               cl_tris, tile, eps, has_tmax=has_tmax,
                               any_hit=any_hit, groups=groups)
