"""Closest-hit intersection over per-tile worklists of fired clusters
(kernel K1, csrc/compact_intersect.cu), with its worklist kernel.

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/
compact_intersect.py::cluster_intersect_compact(worklist=True)``
(``_compact_wl_kernel`` → ``_compact_loop``) and its XLA prepass
(``build_chunk_worklists``).  The function is the same; the TPU
mechanics (one-hot matmuls, roll-prefix ranks, VMEM scratch) are not
carried over, but the TPU kernel's design is: the rays that pass a
cluster's slab are compacted before the triangle tests.

Contract, per ray: visit the ray tile's fired clusters in worklist
order; transform the ray into the cluster object's space; slab-test the
cluster AABB against the running best t (``_slab_inv`` decision table,
including its ``best_t > 0`` guard); if it passes, Möller–Trumbore
against the cluster's S triangles, accepting ``t > eps`` and strictly
closer than the best, lowest slot winning ties.  Miss: t = INF,
tri = obj = -1.  Exact divides throughout (IEEE 1/0 = inf for
axis-aligned directions), as in the JAX interpret twin.

Shadow queries (next-event estimation) set ``has_tmax``: the best t
starts at min(rays8[6], BIG), so only hits closer than t_max count, and
the prepass culls clusters beyond it.  With ``any_hit`` as well, a
lane's first accepted hit blocks it for good: its best t is parked at
-BIG, every later slab test fails, and its t comes out -BIG.  In that
mode tri/obj are not closest-hit values; only the visibility predicate
t < t_max is part of the contract.

On the card: a block of 256 rays inside one worklist tile, each thread
owning one ray's best hit.  Per listed cluster, the rays that pass its
slab enter a shared-memory queue (warp ballot and prefix); the block
stages the rows' prefix of the cluster's 32-slot groups that hold real
triangles only when the queue is not empty, and whole warps test one
queued ray each: its slab against each group's box (``cluster_groups``),
then Möller–Trumbore on the slots of the groups it passes, 32 slots at a
time, reducing to the lowest (t, slot).  Bound: operations — 64 per
group box test, ~52 per (ray, triangle) Möller–Trumbore test, one
divide each.  The queue keeps the triangle tests to the rays that pass,
wherever they sit in a warp, and the groups to the slots near them.

The worklists (``build_chunk_worklists``) come from a kernel of the
same source on the card, one block per tile: the world slab of every
ray against every box, ORed over the tile, then the fired boxes ranked
by the tile's mean direction — a fixed pairwise tree, written out the
same way in ``build_chunk_worklists_plain`` so that the two agree bit
for bit.  It counts as ``worklist_prepass`` (``_build.COUNTS``), K1 as
``compact_intersect``.  ``chunk_world_bounds`` and the ``pack_rays8``
ray pack stay plain torch.  ``PlainSweep`` is the per-ray core in plain
torch, shared by the plain versions of K1 and K4-K8.

Kernel K5 sits beside K1, as in the JAX package: ``worklist_chunk_
intersect`` (csrc/stream_chunk.cu) replaces ``compact_intersect.py::
cluster_intersect_worklist`` (``_worklist_compact_kernel``), the sweep
of scenes beyond the resident budget over per-tile fired 16-cluster
chunks, with K1's per-ray contract.  It counts as ``worklist_chunk``.

So does kernel K7: ``compact_order_intersect`` (csrc/cluster_sweep.cu)
replaces ``cluster_intersect_compact(worklist=False)`` (``_compact_kernel``
→ ``_compact_loop``), K1's contract with every cluster visited in
``cl_order[octant of the tile's first ray]`` and no prepass, its rays
compacted as K4's are (csrc/closest_hit.cuh ``compact_visit``), bit-equal
to its plain version.  It counts as ``compact_order``.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.intersect import INF
from logipathtracer_tpu_torch.ops.kernels import _build

# Internal miss sentinel of the JAX kernel (compact_intersect.py BIG):
# best t starts here, and hits at or beyond it do not count.
BIG = 1e30

SOURCE = "logipathtracer_tpu_torch/csrc/compact_intersect.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/compact_intersect.py:801"
# The worklist kernel (same source).
PREPASS_REPLACES = "logipathtracer_tpu/ops/pallas/compact_intersect.py:587"
# Boxes the worklist kernel takes: a 4-byte key and a bit each in shared
# memory.
MAX_BOXES = 8192

# Kernel K5 (the chunk worklist sweep of streamed scenes), beside K1 as
# in the JAX package.
WORKLIST_SOURCE = "logipathtracer_tpu_torch/csrc/stream_chunk.cu"
WORKLIST_REPLACES = "logipathtracer_tpu/ops/pallas/compact_intersect.py:690"

# Kernel K7 (every cluster in per-octant order, no prepass).
ORDER_SOURCE = "logipathtracer_tpu_torch/csrc/cluster_sweep.cu"
ORDER_REPLACES = "logipathtracer_tpu/ops/pallas/compact_intersect.py:889"

# Rays per vectorized Möller–Trumbore step of a plain visit: bounds the
# [n, S] temporaries (~64 MB each at S = 256).
MT_RAYS = 1 << 16


def pack_rays8(origin, direction, tile: int, t_max=None):
    """Tile-padded [8, Rp] component-major ray block (traverse.py
    _pack_rays8): rows o.xyz, d.xyz, t_max, pad.  Padding rays sit at the
    origin looking down +z, exactly as in the JAX package (they join
    their tile's worklist).  Row 6 holds ``t_max`` on the real lanes and
    INF on the padding when it is given, 0 otherwise."""
    r = origin.shape[0]
    rp = ((r + tile - 1) // tile) * tile
    rays8 = torch.zeros((8, rp), dtype=torch.float32, device=origin.device)
    rays8[5] = 1.0
    rays8[0:3, :r] = origin.T
    rays8[3:6, :r] = direction.T
    if t_max is not None:
        rays8[6] = INF
        rays8[6, :r] = t_max
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


def build_chunk_worklists_plain(chunk_min, chunk_max, rays8, tile: int,
                                has_tmax: bool = False):
    """Plain PyTorch version of the worklist kernel."""
    _build.plain("worklist_prepass")
    fired = fired_chunks(chunk_min, chunk_max, rays8, tile, has_tmax)
    return _order_fired(fired, chunk_min, chunk_max, rays8, tile)


def build_chunk_worklists(chunk_min, chunk_max, rays8, tile: int,
                          has_tmax: bool = False):
    """Per-tile fired-chunk lists (compact_intersect.py:587-643): slab
    every ray of rays8 [8, R] against every world AABB chunk_min /
    chunk_max [NC, 3] (bounded by min(t_max, BIG) with ``has_tmax``),
    any-reduce per ``tile``-ray tile, order the fired boxes front to
    back.  Returns (wl [tiles, NC] i32, wn [tiles] i32).  A CPU tensor
    takes the plain version, a CUDA tensor the worklist kernel (R a
    multiple of ``tile``, 32 <= tile <= 8192, NC <= MAX_BOXES)."""
    dev = rays8.device
    if dev.type == "cpu":
        return build_chunk_worklists_plain(chunk_min, chunk_max, rays8,
                                           tile, has_tmax)
    if dev.type != "cuda":
        raise ValueError(f"build_chunk_worklists: unsupported device {dev}")
    r = rays8.shape[1]
    nc = chunk_min.shape[0]
    if r % tile or not 32 <= tile <= 8192:
        raise ValueError(f"build_chunk_worklists: R={r} must be a multiple "
                         f"of tile={tile}, itself within [32, 8192]")
    if nc > MAX_BOXES:
        raise ValueError(f"build_chunk_worklists: {nc} boxes, the kernel "
                         f"takes at most {MAX_BOXES}")
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(chunk_min, "chunk_min", torch.float32, (nc, 3), dev)
    _build.require(chunk_max, "chunk_max", torch.float32, (nc, 3), dev)
    wl = torch.empty((r // tile, nc), dtype=torch.int32, device=dev)
    wn = torch.empty(r // tile, dtype=torch.int32, device=dev)
    if r:
        _build.launch("compact_intersect", "lpt_build_worklists", chunk_min,
                      chunk_max, nc, rays8, r, tile, bool(has_tmax), wl, wn,
                      _build.stream_ptr(dev))
        _build.launched("worklist_prepass")
    return wl, wn


def fired_chunks(chunk_min, chunk_max, rays8, tile: int,
                 has_tmax: bool = False):
    """[tiles, NC] bool: does some ray of the tile pass the world slab of
    the chunk?  Rays go in blocks so the [NC, block] temporaries stay
    under ~48 MB."""
    r = rays8.shape[1]
    nc = chunk_min.shape[0]
    inv = 1.0 / rays8[3:6]
    best0 = torch.clamp(rays8[6], max=BIG) if has_tmax else None
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
        best = BIG if best0 is None else best0[sl][None]
        ok = _slab_ok(t0, t1, best)                         # [NC, block]
        fired.append(ok.reshape(nc, block // tile, tile).any(dim=2).T)
    return torch.cat(fired, 0)


def tile_mean_dir(rays8, tile: int):
    """[3, tiles]: each tile's mean direction, summed by a fixed
    pairwise tree — adjacent pairs, the tile padded with -0.0 (which
    adds nothing) to a power of two — then divided by the tile.  The
    worklist kernel sums in this order; ``.mean`` sums in its own."""
    tiles = rays8.shape[1] // tile
    d = rays8[3:6].reshape(3, tiles, tile)
    p = 1 << (tile - 1).bit_length()
    if p > tile:
        d = torch.cat([d, d.new_full((3, tiles, p - tile), -0.0)], dim=2)
    while d.shape[2] > 1:
        d = d[:, :, 0::2] + d[:, :, 1::2]
    return d[:, :, 0] / tile


def _order_fired(fired, chunk_min, chunk_max, rays8, tile: int):
    """Fired clusters first, ordered by the tile's mean direction
    (``tile_mean_dir``) dotted with the cluster centroid (stable
    argsort, as the JAX prepass)."""
    centroid = 0.5 * (chunk_min + chunk_max)                 # [NC, 3]
    md = tile_mean_dir(rays8, tile)                          # [3, T]
    key = (md[0][:, None] * centroid[:, 0][None]
           + md[1][:, None] * centroid[:, 1][None]
           + md[2][:, None] * centroid[:, 2][None])          # [T, NC]
    key = torch.where(fired, key, float("inf"))
    wl = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    wn = fired.sum(dim=1).to(torch.int32)
    return wl.contiguous(), wn.contiguous()


def _mt_u(lo, ld, trib):
    """The first part of Möller–Trumbore (csrc/closest_hit.cuh mt_u) for
    rays [n] (components) against one cluster [9, S]: the P vector,
    1 / det, the T vector and u, each [n, S]."""
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
    return det, tx, ty, tz, u


def _mt(lo, ld, trib):
    """Möller–Trumbore of rays [n] (components) against one cluster
    [9, S]: t [n, S], INF on a barycentric miss (cluster_intersect.py
    _mt_cluster with the exact divide)."""
    det, tx, ty, tz, u = _mt_u(lo, ld, trib)
    e1x, e1y, e1z = trib[3][None], trib[4][None], trib[5][None]
    e2x, e2y, e2z = trib[6][None], trib[7][None], trib[8][None]
    dx, dy, dz = (x[:, None] for x in ld)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * det
    t = (e2x * qx + e2y * qy + e2z * qz) * det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    return torch.where(miss, INF, t)


def _slab_table(lo, inv, box, best):
    """_slab_inv's decision table, vectorized over rays: lo/inv [3] lists
    of per-ray components, box the AABB's min xyz then max xyz, best the
    rays' running best t."""
    n = [(box[a] - lo[a]) * inv[a] for a in range(3)]
    f = [(box[3 + a] - lo[a]) * inv[a] for a in range(3)]
    t0 = torch.maximum(torch.maximum(torch.minimum(n[0], f[0]),
                                     torch.minimum(n[1], f[1])),
                       torch.minimum(n[2], f[2]))
    t1 = torch.minimum(torch.minimum(torch.maximum(n[0], f[0]),
                                     torch.maximum(n[1], f[1])),
                       torch.maximum(n[2], f[2]))
    return (t0 <= t1) & (((t0 > 0.0) & (t0 < best))
                         | ((t0 <= 0.0) & (t1 > 0.0) & (best > 0.0)))


class PlainSweep:
    """The per-ray core of the intersect kernels (csrc/closest_hit.cuh)
    in plain PyTorch, shared by the plain versions of K1 and K4-K8:
    the running best (t, tri, obj) of every ray of an [8, R] ray block,
    and cluster visits vectorized over the rays of one tile.

    ``best0`` is the initial best t [R]; ``visit`` updates one tile's
    slice in place."""

    def __init__(self, rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps: float,
                 best0):
        r = rays8.shape[1]
        dev = rays8.device
        self.rays8 = rays8
        self.cl_tris = cl_tris
        self.eps = eps
        self.best_t = best0.contiguous()
        self.best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
        self.best_obj = torch.full((r,), -1, dtype=torch.int32, device=dev)
        self.meta = cl_meta.cpu().tolist()
        self.inv = cl_inv.cpu().tolist()
        self.aabb = cl_aabb.cpu().tolist()
        self.slot_ids = torch.arange(cl_tris.shape[2], device=dev)

    def chunk_gate(self, sl, box, block: int):
        """Lanes of tile ``sl`` whose ``block``-ray block has some ray
        passing the world slab of ``box`` (the kernels' block-wide chunk
        test)."""
        o = self.rays8[0:3, sl]
        inv = 1.0 / self.rays8[3:6, sl]
        hit = _slab_table(list(o), list(inv), box, self.best_t[sl])
        return hit.reshape(-1, block).any(dim=1).repeat_interleave(block)

    def lanes(self, sl, c: int, gate=None):
        """The rays of tile ``sl`` in cluster ``c``'s object space (lo,
        ld: lists of components) and the lanes whose own slab test of the
        cluster passes against the running best, within ``gate``."""
        o = self.rays8[0:3, sl]
        d = self.rays8[3:6, sl]
        m = self.inv[self.meta[c][0]]
        lo = [m[4 * a] * o[0] + m[4 * a + 1] * o[1] + m[4 * a + 2] * o[2]
              + m[4 * a + 3] for a in range(3)]
        ld = [m[4 * a] * d[0] + m[4 * a + 1] * d[1] + m[4 * a + 2] * d[2]
              for a in range(3)]
        hit = _slab_table(lo, [1.0 / x for x in ld], self.aabb[c],
                          self.best_t[sl])
        return lo, ld, hit if gate is None else hit & gate

    def visit(self, sl, c: int, any_hit: bool = False, gate=None,
              subtile: int = 0):
        """Visit cluster ``c`` with the rays of tile ``sl``: local ray,
        slab against the running best, Möller–Trumbore where it passes,
        t > eps strictly closer than the best, lowest slot on ties (a
        NaN t is never accepted, a miss's INF is where the best is +inf,
        as in the sequential loop).  ``gate`` masks the lanes that take
        part.  ``subtile`` > 0: K6's
        cap=0 rule, every ray of a ``subtile``-ray sub-tile with some
        passing ray is tested.  ``any_hit`` parks an accepted lane's best
        t at -BIG."""
        lo, ld, hit = self.lanes(sl, c, gate)
        bt = self.best_t[sl]
        obj, base = self.meta[c]
        if subtile:
            hit = hit.reshape(-1, subtile).any(dim=1).repeat_interleave(
                subtile)
        idx = hit.nonzero().squeeze(1)
        for part in idx.split(MT_RAYS):
            t = _mt([x[part] for x in lo], [x[part] for x in ld],
                    self.cl_tris[c])
            t = torch.where(t > self.eps, t, float("inf"))
            tmin = t.amin(dim=1)
            slot = torch.where(t == tmin[:, None], self.slot_ids,
                               t.shape[1]).amin(dim=1)
            upd = tmin < bt[part]
            j = part[upd]
            bt[j] = -BIG if any_hit else tmin[upd]
            self.best_tri[sl][j] = (base + slot[upd]).to(torch.int32)
            self.best_obj[sl][j] = obj

    def result(self, masked: bool = True):
        """(t, tri, obj); t is INF where no hit was accepted, or the best
        t as it stands with ``masked`` False."""
        t = self.best_t
        if masked:
            t = torch.where(self.best_tri >= 0, t, INF)
        return t, self.best_tri, self.best_obj


def best_init(rays8, has_tmax: bool):
    """K1's initial best t: min(t_max, BIG) with ``has_tmax``, else BIG."""
    if has_tmax:
        return torch.clamp(rays8[6], max=BIG)
    return torch.full((rays8.shape[1],), BIG, dtype=torch.float32,
                      device=rays8.device)


def compact_wl_intersect_plain(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                               cl_tris, tile: int, eps: float,
                               has_tmax: bool = False,
                               any_hit: bool = False):
    """Plain PyTorch version of the kernel: tiles and their worklists in
    a host loop, each visited cluster's slab and Möller–Trumbore
    vectorized over the tile's rays."""
    _build.plain("compact_intersect")
    sweep = PlainSweep(rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps,
                       best_init(rays8, has_tmax))
    wl_h = wl.cpu().tolist()
    for ti, n in enumerate(wn.cpu().tolist()):
        sl = slice(ti * tile, (ti + 1) * tile)
        for c in wl_h[ti][:n]:
            sweep.visit(sl, c, any_hit=any_hit)
    return sweep.result()


def _block_threads(r: int, tile: int, what: str) -> int:
    """Rays per CUDA block: 256, or 128 where the tile is not a multiple
    of 256.  Raises unless R is a multiple of ``tile`` and ``tile`` one
    of 128."""
    if r % tile or tile % 128:
        raise ValueError(f"{what}: R={r} must be a multiple of tile={tile}, "
                         "itself a multiple of 128")
    return 256 if tile % 256 == 0 else 128


def require_scene(cl_meta, cl_inv, cl_aabb, cl_tris, device, stream=False):
    """Check the cluster tables a kernel reads: cl_meta [C, 2] i32,
    cl_inv [O, 12] f32, cl_aabb [C, 8] f32, cl_tris [C, 9, S] f32.
    ``stream``: the kernel copies 16-byte pieces of cl_tris (S a
    multiple of 4, the tensor 16-byte aligned).  Returns (C, S)."""
    c, nine, s = cl_tris.shape
    if nine != 9:
        raise ValueError(f"cl_tris: shape {tuple(cl_tris.shape)}, expected "
                         "[C, 9, S]")
    _build.require(cl_meta, "cl_meta", torch.int32, (c, 2), device)
    _build.require(cl_inv, "cl_inv", torch.float32, (None, 12), device)
    _build.require(cl_aabb, "cl_aabb", torch.float32, (c, 8), device)
    _build.require(cl_tris, "cl_tris", torch.float32, (c, 9, s), device)
    if stream and (s % 4 or cl_tris.data_ptr() % 16):
        raise ValueError(f"cl_tris: S={s} must be a multiple of 4 and the "
                         "tensor 16-byte aligned for cp.async")
    return c, s


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
    """The 32-slot groups of each cluster that K1's and K4's triangle
    tests take (closest_hit.cuh ``Groups``, ``warp_groups``):
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


def require_groups(groups, cl_meta, cl_inv, cl_aabb, cl_tris, device):
    """(box, n, G) of the 32-slot groups a kernel takes: ``groups``
    checked against the cluster tables, or their ``cluster_groups`` when
    None."""
    if groups is None:
        groups = cluster_groups(cl_meta, cl_inv, cl_aabb, cl_tris)
    gbox, gn = groups
    c, _, s = cl_tris.shape
    g = -(-s // GROUP)
    _build.require(gbox, "gbox", torch.float32, (c, g, 8), device)
    _build.require(gn, "gn", torch.int32, (c,), device)
    return gbox, gn, g


def compact_wl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb, cl_tris,
                         tile: int, eps: float, has_tmax: bool = False,
                         any_hit: bool = False, groups=None):
    """Closest hit for rays8 [8, R] (R a multiple of ``tile``) over the
    worklists wl [R/tile, C] i32 / wn [R/tile] i32.  cl_meta [C, 2] i32,
    cl_inv [O, 12] f32, cl_aabb [C, 8] f32, cl_tris [C, 9, S] f32.
    ``has_tmax``/``any_hit``: the shadow-query modes (module docstring).
    ``groups``: the tables' ``cluster_groups``, built here when None on
    the card (a scene keeps its own, ops/traverse.py
    ``scene_cluster_groups``).  Returns (t [R] f32, tri [R] i32, obj [R]
    i32).  A CPU tensor takes the plain version (which needs no groups:
    it gives the same answer), a CUDA tensor the kernel (compacted
    visits, the triangle test by groups)."""
    dev = rays8.device
    if dev.type == "cpu":
        return compact_wl_intersect_plain(rays8, wl, wn, cl_meta, cl_inv,
                                          cl_aabb, cl_tris, tile, eps,
                                          has_tmax, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"compact_wl_intersect: unsupported device {dev}")
    r = rays8.shape[1]
    threads = _block_threads(r, tile, "compact_wl_intersect")
    c, s = require_scene(cl_meta, cl_inv, cl_aabb, cl_tris, dev)
    gbox, gn, g = require_groups(groups, cl_meta, cl_inv, cl_aabb, cl_tris,
                                 dev)
    tiles = r // tile
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(wl, "wl", torch.int32, (tiles, c), dev)
    _build.require(wn, "wn", torch.int32, (tiles,), dev)
    t, tri, obj = _outputs(r, dev)
    _build.launch("compact_intersect", "lpt_compact_wl_intersect",
                  rays8, r, wl, wn, c, tile, cl_meta, cl_inv, cl_aabb,
                  cl_tris, s, gbox, gn, g, float(eps), threads,
                  bool(has_tmax), bool(any_hit), t, tri, obj,
                  _build.stream_ptr(dev))
    _build.launched("compact_intersect", _mode(has_tmax, any_hit))
    return t, tri, obj


def _outputs(r: int, dev):
    return (torch.empty(r, dtype=torch.float32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev))


def _mode(has_tmax: bool, any_hit: bool) -> str:
    return ("any_hit" if any_hit else "tmax") if has_tmax else "closest"


def tile_octants(rays8, tile: int):
    """[tiles] i32: the direction octant of each ``tile``-ray tile's
    first ray (compact_intersect.py:375-377, cluster_intersect.py:
    225-227): 4 * (dx > 0) + 2 * (dy > 0) + (dz > 0)."""
    d0 = rays8[3:6, ::tile]
    return ((d0[0] > 0).to(torch.int32) * 4 + (d0[1] > 0).to(torch.int32) * 2
            + (d0[2] > 0).to(torch.int32)).contiguous()


def order_sweep_plain(rays8, oct_, order, cl_meta, cl_inv, cl_aabb, cl_tris,
                      tile: int, eps: float, best0, any_hit: bool = False,
                      subtile: int = 0, masked: bool = True):
    """The plain core of K7 and K8: every tile visits all C clusters in
    order[oct_[tile]].  Tiles are batched by octant — one vectorized
    visit per (octant, cluster), 8·C visits in all, not tiles·C — which
    gives the same result, since a visit updates each ray from its own
    state only (and, with ``subtile``, from its own 128-ray sub-tile,
    which never straddles two tiles)."""
    r = rays8.shape[1]
    dev = rays8.device
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    obj = torch.empty(r, dtype=torch.int32, device=dev)
    ray_oct = oct_.repeat_interleave(tile)
    order_h = order.cpu().tolist()
    for oc in sorted(set(oct_.cpu().tolist())):
        idx = (ray_oct == oc).nonzero().squeeze(1)
        sweep = PlainSweep(rays8[:, idx], cl_meta, cl_inv, cl_aabb, cl_tris,
                           eps, best0[idx])
        for c in order_h[oc]:
            sweep.visit(slice(None), c, any_hit=any_hit, subtile=subtile)
        t[idx], tri[idx], obj[idx] = sweep.result(masked)
    return t, tri, obj


def compact_order_intersect_plain(rays8, oct_, order, cl_meta, cl_inv,
                                  cl_aabb, cl_tris, tile: int, eps: float,
                                  has_tmax: bool = False,
                                  any_hit: bool = False):
    """Plain PyTorch version of K7 (``order_sweep_plain`` with K1's
    contract)."""
    _build.plain("compact_order")
    return order_sweep_plain(rays8, oct_, order, cl_meta, cl_inv, cl_aabb,
                             cl_tris, tile, eps, best_init(rays8, has_tmax),
                             any_hit=any_hit)


def compact_order_intersect(rays8, oct_, order, cl_meta, cl_inv, cl_aabb,
                            cl_tris, tile: int, eps: float,
                            has_tmax: bool = False, any_hit: bool = False):
    """Kernel K7: closest hit for rays8 [8, R] (R a multiple of ``tile``)
    visiting every cluster in order[oct_[tile]] (order [8, C] i32, oct_
    [R/tile] i32 from ``tile_octants``).  K1's contract, shadow modes
    included.  A CPU tensor takes the plain version, a CUDA tensor the
    kernel."""
    dev = rays8.device
    args = (rays8, oct_, order, cl_meta, cl_inv, cl_aabb, cl_tris, tile, eps,
            has_tmax, any_hit)
    if dev.type == "cpu":
        return compact_order_intersect_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"compact_order_intersect: unsupported device {dev}")
    r = rays8.shape[1]
    threads = _block_threads(r, tile, "compact_order_intersect")
    t, tri, obj = launch_order(rays8, oct_, order, cl_meta, cl_inv, cl_aabb,
                               cl_tris, tile, eps, threads, False, has_tmax,
                               any_hit)
    _build.launched("compact_order", _mode(has_tmax, any_hit))
    return t, tri, obj


def launch_order(rays8, oct_, order, cl_meta, cl_inv, cl_aabb, cl_tris,
                 tile: int, eps: float, threads: int, subtile: bool,
                 has_tmax: bool, any_hit: bool):
    """Check the inputs of K7 / K8 (csrc/cluster_sweep.cu) and launch one
    of them on the current stream (K8 copies 16-byte pieces of
    cl_tris)."""
    dev = rays8.device
    r = rays8.shape[1]
    c, s = require_scene(cl_meta, cl_inv, cl_aabb, cl_tris, dev,
                         stream=subtile)
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(oct_, "oct", torch.int32, (r // tile,), dev)
    _build.require(order, "order", torch.int32, (8, c), dev)
    t, tri, obj = _outputs(r, dev)
    _build.launch("cluster_sweep", "lpt_cluster_order_intersect", rays8, r,
                  oct_, order, c, tile, cl_meta, cl_inv, cl_aabb, cl_tris, s,
                  float(eps), threads, bool(subtile), bool(has_tmax),
                  bool(any_hit), t, tri, obj, _build.stream_ptr(dev))
    return t, tri, obj


def cluster_intersect_compact(cl_meta, cl_inv, cl_aabb, cl_tris, rays8,
                              obj_world, tile: int = 4096,
                              eps: float = 1e-4, bounds=None,
                              has_tmax: bool = False,
                              any_hit: bool = False, worklist: bool = True,
                              cl_order=None, groups=None, fired=None):
    """The port of the JAX package's ``cluster_intersect_compact``:
    with ``worklist`` the worklist prepass + K1 (``bounds`` may carry
    precomputed ``chunk_world_bounds`` and ``groups`` the tables'
    ``cluster_groups``: the scene's are constant; ``fired``, a
    one-element int64 tensor, takes the sum of the prepass's ``wn``, on
    the device); without, K7 over the per-octant cluster order
    ``cl_order`` [8, C]."""
    if not worklist:
        return compact_order_intersect(rays8, tile_octants(rays8, tile),
                                       cl_order, cl_meta, cl_inv, cl_aabb,
                                       cl_tris, tile, eps, has_tmax=has_tmax,
                                       any_hit=any_hit)
    if bounds is None:
        c0 = cl_tris.shape[0]
        bounds = chunk_world_bounds(cl_meta, cl_aabb, obj_world, c0, c0, 1)
    wl, wn = build_chunk_worklists(bounds[0], bounds[1], rays8, tile,
                                   has_tmax=has_tmax)
    if fired is not None:
        fired.add_(wn.sum())
    return compact_wl_intersect(rays8, wl, wn, cl_meta, cl_inv, cl_aabb,
                                cl_tris, tile, eps, has_tmax=has_tmax,
                                any_hit=any_hit, groups=groups)


def padded_chunk_bounds(cl_meta, cl_aabb, obj_world, chunk: int):
    """World AABBs of ``chunk``-cluster chunks, the cluster tables padded
    to a chunk multiple as in the JAX package (compact_intersect.py:
    726-742): a padded slot gets INF / -INF bounds.  Returns (min, max),
    each [ceil(C / chunk), 3]."""
    c = cl_meta.shape[0]
    cp = -(-c // chunk) * chunk
    meta = torch.cat([cl_meta, cl_meta.new_zeros((cp - c, 2))])
    aabb = torch.cat([cl_aabb, cl_aabb.new_zeros((cp - c, 8))])
    return chunk_world_bounds(meta, aabb, obj_world, c, cp, chunk)


def visit_chunk_plain(sweep, sl, jc: int, box, chunk: int, num_real: int,
                      block: int, any_hit: bool = False, subtile: int = 0):
    """One chunk of the chunk kernels' member-cluster loop
    (csrc/stream_chunk.cu ``visit_chunk``): the block-wide test of the
    chunk's world box with the live best t, then each member cluster
    c < ``num_real`` for the lanes of the blocks that passed."""
    gate = sweep.chunk_gate(sl, box, block)
    if not bool(gate.any()):
        return
    for c in range(jc * chunk, min((jc + 1) * chunk, num_real)):
        sweep.visit(sl, c, any_hit=any_hit, gate=gate, subtile=subtile)


def worklist_chunk_intersect_plain(rays8, wl, wn, chunk_aabb, cl_meta,
                                   cl_inv, cl_aabb, cl_tris, tile: int,
                                   chunk: int, eps: float,
                                   has_tmax: bool = False,
                                   any_hit: bool = False):
    """Plain PyTorch version of K5: tiles, their fired chunks and the
    chunks' member clusters in host loops, each visit vectorized over
    the tile's rays."""
    _build.plain("worklist_chunk")
    r = rays8.shape[1]
    block = _block_threads(r, tile, "worklist_chunk_intersect")
    sweep = PlainSweep(rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps,
                       best_init(rays8, has_tmax))
    boxes = chunk_aabb.cpu().tolist()
    wl_h = wl.cpu().tolist()
    for ti, n in enumerate(wn.cpu().tolist()):
        sl = slice(ti * tile, (ti + 1) * tile)
        for jc in wl_h[ti][:n]:
            visit_chunk_plain(sweep, sl, jc, boxes[jc], chunk,
                              cl_tris.shape[0], block, any_hit=any_hit)
    return sweep.result()


def worklist_chunk_intersect(rays8, wl, wn, chunk_aabb, cl_meta, cl_inv,
                             cl_aabb, cl_tris, tile: int, chunk: int,
                             eps: float, has_tmax: bool = False,
                             any_hit: bool = False):
    """Kernel K5: closest hit for rays8 [8, R] over the per-tile
    fired-chunk lists wl [R/tile, NC] i32 / wn [R/tile] i32 of
    ``chunk``-cluster chunks whose world AABBs are chunk_aabb [NC, 6]
    (min xyz, max xyz).  The cluster tables are K1's, unpadded: member
    clusters at or beyond C are never visited.  K1's contract, shadow
    modes included.  A CPU tensor takes the plain version, a CUDA tensor
    the kernel."""
    dev = rays8.device
    args = (rays8, wl, wn, chunk_aabb, cl_meta, cl_inv, cl_aabb, cl_tris,
            tile, chunk, eps, has_tmax, any_hit)
    if dev.type == "cpu":
        return worklist_chunk_intersect_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"worklist_chunk_intersect: unsupported device {dev}")
    r = rays8.shape[1]
    threads = _block_threads(r, tile, "worklist_chunk_intersect")
    c, s = require_scene(cl_meta, cl_inv, cl_aabb, cl_tris, dev, stream=True)
    nc = -(-c // chunk)
    tiles = r // tile
    _build.require(rays8, "rays8", torch.float32, (8, r), dev)
    _build.require(wl, "wl", torch.int32, (tiles, nc), dev)
    _build.require(wn, "wn", torch.int32, (tiles,), dev)
    _build.require(chunk_aabb, "chunk_aabb", torch.float32, (nc, 6), dev)
    t, tri, obj = _outputs(r, dev)
    _build.launch("stream_chunk", "lpt_worklist_chunk_intersect",
                  rays8, r, wl, wn, nc, tile, chunk, c, chunk_aabb, cl_meta,
                  cl_inv, cl_aabb, cl_tris, s, float(eps), threads,
                  bool(has_tmax), bool(any_hit), t, tri, obj,
                  _build.stream_ptr(dev))
    _build.launched("worklist_chunk", _mode(has_tmax, any_hit))
    return t, tri, obj


def cluster_intersect_worklist(cl_meta, cl_inv, cl_aabb, cl_tris, obj_world,
                               rays8, tile: int = 4096, chunk: int = 16,
                               eps: float = 1e-4, has_tmax: bool = False,
                               any_hit: bool = False, bounds=None):
    """Chunk prepass + K5: the port of the JAX package's
    ``cluster_intersect_worklist``.  ``bounds`` may carry precomputed
    ``padded_chunk_bounds`` (the scene's are constant)."""
    if bounds is None:
        bounds = padded_chunk_bounds(cl_meta, cl_aabb, obj_world, chunk)
    wl, wn = build_chunk_worklists(bounds[0], bounds[1], rays8, tile,
                                   has_tmax=has_tmax)
    chunk_aabb = torch.cat(bounds, dim=1).contiguous()
    return worklist_chunk_intersect(rays8, wl, wn, chunk_aabb, cl_meta,
                                    cl_inv, cl_aabb, cl_tris, tile, chunk,
                                    eps, has_tmax=has_tmax, any_hit=any_hit)


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
