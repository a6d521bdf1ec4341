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
(``cluster_groups``) and runs the triangle test only on the groups it
passes.  See the source's note.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.frustum import frustum_cluster_mask
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci

SOURCE = "logipathtracer_tpu_torch/csrc/stream_cluster.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/stream_cluster.py:218"

GROUP = 32          # slots a group: a warp's lanes (closest_hit.cuh)
GROUP_PAD = 1e-5    # ops/frustum.py's relative pad


def _corners(lo, hi):
    """The 8 corners [..., 8, 3] of boxes lo, hi [..., 3]."""
    pick = torch.tensor([[(i >> a) & 1 for a in range(3)] for i in range(8)],
                        dtype=torch.bool, device=lo.device)
    return torch.where(pick, hi[..., None, :], lo[..., None, :])


def _scene_reach(cl_meta, cl_inv, cl_aabb):
    """[C] f32: per cluster, the largest |coordinate| of the scene's
    world box (the cluster boxes' world bounds) in the cluster's object
    space: how far, in that space, a ray from inside the scene starts
    from the origin."""
    o = cl_inv.shape[0]
    inv = torch.eye(4, dtype=torch.float64).repeat(o, 1, 1)
    inv[:, :3] = cl_inv.detach().cpu().double().reshape(o, 3, 4)
    fwd = torch.linalg.inv(inv)
    obj = cl_meta[:, 0].long().cpu()
    box = cl_aabb.detach().cpu().double()
    m = fwd[obj]                                             # [C, 4, 4]
    world = (_corners(box[:, 0:3], box[:, 3:6]) @ m[:, :3, :3].mT
             + m[:, None, :3, 3])                            # [C, 8, 3]
    sc = _corners(world.amin(dim=(0, 1)), world.amax(dim=(0, 1)))
    local = sc[None] @ inv[:, :3, :3].mT + inv[:, None, :3, 3]
    reach = local.abs().amax(dim=(1, 2))                     # [O]
    return reach[obj].float().to(cl_aabb.device)


def cluster_groups(cl_meta, cl_inv, cl_aabb, cl_tris):
    """K4's 32-slot groups of each cluster (closest_hit.cuh ``Groups``):
    (box [C, G, 8] f32, n [C] i32), G = ceil(S / 32).  Group g holds slots
    32g .. 32g + 31.  A cluster's real slots are a prefix: n is
    ceil(count / 32), count being one past its last slot that is not all
    zero (an all-zero slot is never accepted: its t is NaN).  Box g
    (min.xyz, max.xyz, 0, 0) bounds v0, v0 + e1 and v0 + e2 of the group's
    slots below count, in the cluster's object space, padded outward per
    axis by ``GROUP_PAD`` (|min| + |max| + 1 + 2 ``_scene_reach``): the
    rounding of the slab test and of Möller–Trumbore grows with the
    distance from the ray's origin, so the pad scales with the farthest
    a ray from inside the scene starts, and a slot that the triangle
    test accepts is never culled.  The boxes of groups from n on are
    NaN, a slab that never passes; the kernel never reads them."""
    c, _, s = cl_tris.shape
    g = -(-s // GROUP)
    tris = torch.nn.functional.pad(cl_tris, (0, g * GROUP - s))
    slot = torch.arange(1, g * GROUP + 1, device=cl_tris.device)
    count = torch.where((tris != 0).any(dim=1), slot, 0).amax(dim=1)
    n = (count + GROUP - 1) // GROUP
    v0 = tris[:, 0:3]
    pts = torch.stack([v0, v0 + tris[:, 3:6], v0 + tris[:, 6:9]], 1)
    real = (slot[None] <= count[:, None])[:, None, None]     # [C, 1, 1, S']
    inf = float("inf")
    lo = torch.where(real, pts, inf).amin(dim=1)             # [C, 3, S']
    hi = torch.where(real, pts, -inf).amax(dim=1)
    lo = lo.reshape(c, 3, g, GROUP).amin(dim=3).mT           # [C, G, 3]
    hi = hi.reshape(c, 3, g, GROUP).amax(dim=3).mT
    reach = _scene_reach(cl_meta, cl_inv, cl_aabb)[:, None, None]
    pad = GROUP_PAD * (lo.abs() + hi.abs() + 1.0 + 2.0 * reach)
    box = torch.zeros((c, g, 8), dtype=torch.float32, device=cl_tris.device)
    box[:, :, 0:3] = lo - pad
    box[:, :, 3:6] = hi + pad
    empty = torch.arange(g, device=cl_tris.device)[None] >= n[:, None]
    box[:, :, 0:6] = torch.where(empty[..., None], float("nan"),
                                 box[:, :, 0:6])
    return box.contiguous(), n.to(torch.int32)


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
    ``cluster_groups``, built here when None (a scene keeps its own,
    ops/traverse.py ``scene_cluster_groups``).  Returns (t [R] f32, tri
    [R] i32, obj [R] i32).  A CPU tensor takes the plain version, a CUDA
    tensor the kernel."""
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
    if groups is None:
        groups = cluster_groups(cl_meta, cl_inv, cl_aabb, cl_tris)
    gbox, gn = groups
    g = -(-s // GROUP)
    tiles = r // tile
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(wl, "wl", torch.int32, (tiles, c), dev)
    _build.require(wn, "wn", torch.int32, (tiles,), dev)
    _build.require(gbox, "gbox", torch.float32, (c, g, 8), dev)
    _build.require(gn, "gn", torch.int32, (c,), dev)
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
                                bounds=None, groups=None):
    """Frustum prepass + K4: the port of the JAX package's
    ``cluster_intersect_stream_cl``.  ``bounds`` may carry precomputed
    per-cluster ``chunk_world_bounds`` and ``groups`` the tables'
    ``cluster_groups`` (the scene's are constant)."""
    if bounds is None:
        c = cl_tris.shape[0]
        bounds = ci.chunk_world_bounds(cl_meta, cl_aabb, obj_world, c, c, 1)
    wl, wn = build_cluster_worklists(bounds[0], bounds[1], rays8, tile,
                                     has_tmax=has_tmax,
                                     chunk_gate=chunk_gate)
    return stream_cl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                               cl_tris, tile, eps, has_tmax=has_tmax,
                               any_hit=any_hit, groups=groups)
