"""Pooled wavefront renderer (the JAX package's ``render/wavefront.py``):
``render_wavefront`` renders S samples of a row slab in one fresh pool;
the carryover form ``wavefront_chunk`` / ``wavefront_drain`` keeps the
pool between calls.

A persistent pool of P lanes.  Every iteration:

  1. sort: alive lanes by ray coherence key, then free lanes, then
     retired lanes keyed by pixel id (``torch.sort(stable=True)``, the
     stable ``lax.sort`` of the reference), and flush the retired tail
     into the accumulator (kernel K3);
  2. regen: refill free lanes with the next (pixel, sample) work items;
  3. park dead lanes at a far origin;
  4. intersect the alive prefix (kernel K1 and its worklist prepass for
     a resident-class scene; K4, K5 or K6 and theirs for a scene beyond
     the resident budget, render/megakernel.py ``pick_intersect``);
  5. shade it (kernel K2; textured scenes run the texture prologue
     first, and with NEE the shadow rays K2 prepares go through the
     same intersect kernel again in t_max / any-hit mode — they are not
     counted in ``rays``, as in the JAX package, but in the device
     counter ``shadow_rays``, the trace's column of the pool's
     ``counts``).

The iteration is built as the JAX body is, with static shapes: two
device-only stages around one host read (``_Body``).  Stage A sorts
(or, unsorted, flushes in place) and writes the alive, pending and free
counts to a device buffer; the host reads them once, picks stage B's
window and keeps its mirrors of ``next_work`` and the iteration count
(the loop tests) in step with the device.  Stage B regenerates, parks,
traces and shades: every value it needs (n_alive, n_new, next_work,
the regen start, the ray and iteration counters) comes from device
tensors, and its windows come from fixed ladders of whole-tile widths,
the pool's halvings P, P/2, P/4, ... (a superset of JAX's
``regen_caps`` and ``trace_caps``), down to ``REGEN_FLOOR`` for regen
and to one tile for the trace.  After a sort the
alive lanes form a prefix, so regen ranks the free lanes of the window
[min(n_alive, P - cap), +cap) (the JAX ``regen_sliced`` start) and
steps 4-5 run on the prefix [0, cap); unsorted iterations take the
whole pool, ranking its free lanes by a cumulative sum.  A wider window
traces dead lanes too: they are parked, pass through K2 unchanged and
regen overwrites them before use, so alive lanes get the same values
on every rung.

On a CUDA device each stage of a pool is captured once into a CUDA
graph and replayed (render/graph.py, the counterpart of ``jax.jit``
around the JAX ``while_loop``): an iteration is a stage-A replay, the
host read and a stage-B replay.  The pool state and the frame's inputs
(camera, tan of half the field of view, host seeds, work total) stay at
fixed addresses, copied into before a call.  Intersect modes that read
the host in their own loop (graph.EAGER_MODES: the BVH walk and the jnp
twin of the sweep) run eagerly, as does the CPU, which runs the same
stages; ``_eager=True`` asks the loop functions for the eager form on
the card (for comparisons: chip_smoke.py holds the two bit-equal).

The loop reports into utils/trace.py: on the card a stopwatch stamp at
each stage boundary, captured with the stages, times them on the
device into the pool's ``counts`` buffer, which the count read brings
to the host; each call ends in a record of its iterations, host syncs
and stage times.

Per-(pixel, sample) RNG streams and draw order equal the JAX package's,
so each work item's radiance matches up to intersect near-ties and the
last ulps of the device libm.  ``pool_cm`` and ``sort_variadic`` choose
TPU layouts and are ignored; ``sort_rays``, ``sort_every``,
``lazy_regen`` and ``max_depth`` are honoured.
"""

from __future__ import annotations

import bisect
import weakref

import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.camera import (camera_constants,
                                                 generate_ray)
from logipathtracer_tpu_torch.ops.kernels.flush import flush_sorted
from logipathtracer_tpu_torch.ops.rng import get_rand, seed_from_pixel
from logipathtracer_tpu_torch.render.graph import graph_cache, uses_graphs
from logipathtracer_tpu_torch.render.megakernel import (intersect_tile,
                                                        pick_intersect,
                                                        ray_sort_key,
                                                        shade_step)
from logipathtracer_tpu_torch.utils import trace as tracing

_LANE_KEYS = ("origin", "direction", "mask", "acc", "seed", "alive",
              "pending", "prev_pdf", "bounce", "pixid")

# Smallest regen and trace windows of the ladders, whose rungs halve
# the pool.  Performance knobs only: every rung gives alive lanes the
# same values, and tests shrink them to reach the ladder on CPU-sized
# pools.  REGEN_FLOOR is the JAX package's (wavefront.py:58-67): below
# it an elementwise stage costs about its launches.  The trace ladder
# goes down to one tile: JAX's trace_caps stop at P/4 above
# TRACE_FLOOR = 2^17, each rung one more compiled TPU program, where
# here a rung is one more captured graph (milliseconds, once), and a
# drain tail traced at P/4, or a pool under 2^17 lanes (the 480x270
# preview) traced whole, costs device time an iteration.
REGEN_FLOOR = 1 << 15
TRACE_FLOOR = 1

# Host seeds the frame's seed buffer holds at least: a step(n) with more
# samples than the buffer holds grows it and re-captures the pool's
# stages.
SEED_CAPACITY = 64


def pix_layout(cfg: RenderConfig, scene, rows: int, w: int):
    """Block-major pixel mapping, one worklist tile = one compact pixel
    block.  Returns (blocked, bh, bw)."""
    bw = 32
    bh = max(intersect_tile(cfg, scene) // bw, 1)
    return (rows % bh == 0) and (w % bw == 0), bh, bw


def _pix_coords(pixi, blocked: bool, bh: int, bw: int, w: int, y0: int):
    if blocked:
        per_block = bh * bw
        blk = pixi // per_block
        within = pixi % per_block
        px = (blk % (w // bw)) * bw + within % bw
        py = (blk // (w // bw)) * bh + within // bw
    else:
        px = pixi % w
        py = pixi // w
    return px.to(torch.float32), (py + y0).to(torch.float32)


def unblock_accum(accum, blocked: bool, bh: int, bw: int, rows: int, w: int):
    """Undo the block-major pixel mapping -> [rows, w, 3] frame."""
    if blocked:
        accum = accum.reshape(rows // bh, w // bw, bh, bw, 3).permute(
            0, 2, 1, 3, 4)
    return accum.reshape(rows, w, 3)


def wavefront_pool_state(p: int, npix: int, device="cpu"):
    """Fresh pool: every lane free, zero accumulation.  Lane state and
    the counters ``next_work``, ``rays`` and ``it`` are device tensors at
    fixed addresses; ``counts`` holds stage A's alive, pending and free
    counts, then the stopwatch's slots, the shadow rays NEE cast since
    the pool was made (``shadow_rays``, a view), the (tile, box) pairs
    their worklist prepass fired (``shadow_clusters``, a view) and the
    stamp (utils/trace.py); ``host_next_work`` and ``host_it`` are the
    host's mirrors of ``next_work`` and ``it`` for the loop tests, and
    ``slots_seen``, ``shadow_seen`` and ``clusters_seen`` the slots
    (None off the card), shadow rays and shadow clusters as the trace
    last took them."""
    dev = torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    counts = torch.zeros((tracing.WIDTH,), **i64)
    st = dict(
        origin=torch.empty((p, 3), device=dev),
        direction=torch.empty((p, 3), device=dev),
        mask=torch.empty((p, 3), device=dev),
        acc=torch.empty((p, 3), device=dev),
        seed=torch.empty((p, 2), **i64),
        alive=torch.empty((p,), dtype=torch.bool, device=dev),
        pending=torch.empty((p,), dtype=torch.bool, device=dev),
        prev_pdf=torch.empty((p,), device=dev),
        bounce=torch.empty((p,), dtype=torch.int32, device=dev),
        pixid=torch.empty((p,), dtype=torch.int32, device=dev),
        next_work=torch.empty((), **i64),
        accum=torch.empty((npix, 3), device=dev),
        rays=torch.empty((), **i64),
        it=torch.empty((), **i64),
        counts=counts,
        shadow_rays=counts[tracing.SHADOW],
        shadow_clusters=counts[tracing.CLUSTERS],
        slots_seen=([0] * len(tracing.SLOTS) if dev.type == "cuda"
                    else None),
        shadow_seen=0,
        clusters_seen=0,
    )
    return reset_pool_state(st)


def reset_pool_state(st):
    """Empty the pool in place (a camera move): the state of a fresh
    ``wavefront_pool_state`` at the same addresses, so the stages
    captured for the pool stay valid.  The stopwatch's slots and the
    shadow rays go on counting.  Returns ``st``."""
    for k in ("origin", "mask", "acc", "seed", "alive", "pending",
              "prev_pdf", "bounce", "pixid", "next_work", "accum", "rays",
              "it"):
        st[k].zero_()
    st["counts"][:tracing.COUNTS].zero_()
    st["mask"].fill_(1.0)
    st["direction"].zero_()
    st["direction"][:, 2] = 1.0
    st["host_next_work"] = 0
    st["host_it"] = 0
    return st


def _rows(x, idx):
    """``x[idx]`` for a lane array, bit for bit, as an element gather on
    the flat array.  Rows of 16 bytes (the [P, 2] int64 seeds) would
    take torch's row-vectorised gather by indexing or ``torch.gather``
    alike, which ran 0.63 ms for 2^20 rows on an H100 (the sort's seed
    gather, in a torch.profiler trace of the loop)."""
    if x.dim() == 1:
        return x[idx]
    k = x.shape[1]
    flat = idx[:, None] * k + torch.arange(k, device=idx.device)
    return x.reshape(-1)[flat.reshape(-1)].reshape(-1, k)


def _flush_unsorted(st):
    """Flush retired lanes wherever they sit: order them by pixel id
    (stable, so one pixel's rows keep lane order — the scatter order of
    the reference) and run the sorted flush.  In place."""
    flush = st["pending"] & ~st["alive"]
    key = torch.where(flush, st["pixid"], -1)
    key, perm = torch.sort(key, stable=True)
    flush_sorted(st["accum"], key.to(torch.int32).contiguous(),
                 st["acc"][perm].contiguous())
    st["pending"] &= ~flush


def halvings(p: int):
    """The fractions 2, 4, ... of a pool of ``p`` lanes, down to a lane:
    ``ladder``'s rungs P/2, P/4, ... (a superset of JAX's regen_caps
    P/16 ... P/2 and trace_caps P/4, P/2)."""
    return tuple(1 << k for k in range(1, p.bit_length()))


def ladder(p: int, tile: int, fractions, floor: int, clamp: bool):
    """A window ladder of pool ``p``: each p // f of ``fractions``, raised
    to ``floor`` (``clamp``, as JAX's regen_caps) or dropped below it
    (as JAX's trace_caps), rounded up to whole tiles; and p."""
    rungs = {p}
    for f in fractions:
        c = p // f
        if clamp:
            c = max(c, floor)
        elif c < floor:
            continue
        c = -(-c // tile) * tile
        if c < p:
            rungs.add(c)
    return sorted(rungs)


class _Body:
    """One wavefront iteration of a pool for a fixed (scene, config,
    frame): stage A, the host read, stage B (module docstring).  The
    frame's inputs live in buffers of the body (``set_inputs``); on a
    CUDA device the body keeps its captured stages."""

    def __init__(self, scene, cfg: RenderConfig, st, npix: int,
                 pix_coords):
        # Weakly: on the card the scene keeps the body (graph_cache), and
        # a cycle would hold the pool and its graphs' memory until a
        # garbage collection.
        self.scene = weakref.proxy(scene)
        self.cfg = cfg
        self.st = st
        self.p = p = st["pixid"].shape[0]
        self.npix = npix
        self.pix_coords = pix_coords
        self.isect = pick_intersect(cfg, scene)
        self.tile = tile = intersect_tile(cfg, scene)
        self.regen_rungs = ladder(p, tile, halvings(p), REGEN_FLOOR, True)
        self.trace_rungs = ladder(p, tile, halvings(p), TRACE_FLOOR, False)
        dev = st["pixid"].device
        self.cam = torch.eye(4, device=dev)
        self.consts = camera_constants(0.0, (cfg.render_width,
                                             cfg.render_height), dev)
        self.seeds = torch.zeros((SEED_CAPACITY, 2), dtype=torch.int64,
                                 device=dev)
        self.total = torch.zeros((), dtype=torch.int64, device=dev)
        self.total_host = 0
        self.stages = {}

    def set_inputs(self, cam_world, fov_y, ubo_seeds):
        """Copy a chunk's camera, field of view and host seeds into the
        body's buffers; the work total is S * npix."""
        s = int(ubo_seeds.shape[0])
        if s > self.seeds.shape[0]:
            self.seeds = torch.zeros((s, 2), dtype=torch.int64,
                                     device=self.seeds.device)
            self.stages.clear()
        self.seeds[:s].copy_(ubo_seeds)
        self.cam.copy_(cam_world)
        _, tan_half = camera_constants(fov_y, (1, 1), "cpu")
        tracing.host_sync("upload")
        self.consts[1].copy_(tan_half)
        self.total_host = s * self.npix
        self.total.fill_(self.total_host)

    # -- stage A: sort, flush and count ---------------------------------

    def stage_a(self, mode: str):
        """``mode``: "sort" (sort and flush the retired tail), "unsorted"
        (flush retired lanes in place) or "none" (a sort_every > 1
        iteration between sorts).  Writes counts = (alive, pending,
        free)."""
        st = self.st
        tracing.stamp(st["counts"], None)
        if mode == "sort":
            self._sort_and_flush()
        elif mode == "unsorted":
            _flush_unsorted(st)
        free = ~st["alive"] & ~st["pending"]
        st["counts"][:tracing.COUNTS].copy_(torch.stack((
            st["alive"].sum(), st["pending"].sum(), free.sum())))
        tracing.stamp(st["counts"], "stage_a")

    def _sort_and_flush(self):
        st = self.st
        alive, pending = st["alive"], st["pending"]
        retired = pending & ~alive
        key = torch.where(
            alive, ray_sort_key(self.scene, st["origin"], st["direction"]),
            torch.where(retired, (1 << 18) + 1 + st["pixid"], 1 << 18))
        _, perm = torch.sort(key, stable=True)
        for k in _LANE_KEYS:
            st[k].copy_(_rows(st[k], perm))
        # Retired lanes now form the tail, ascending by pixel id.
        flush = st["pending"] & ~st["alive"]
        flush_sorted(st["accum"],
                     torch.where(flush, st["pixid"], -1).to(torch.int32),
                     st["acc"])
        st["pending"] &= ~flush

    # -- the host read's plan ----------------------------------------------

    def plan(self, counts, drain: bool, sorted_now: bool):
        """From stage A's counts: (n_new, regen window, trace window,
        whether any lane is pending after the iteration).  A window is 0
        where its step has no lane to do."""
        n_alive, n_pending, n_free = counts
        p, cfg = self.p, self.cfg
        n_new = 0
        if not drain:
            remaining = self.total_host - self.st["host_next_work"]
            if (cfg.lazy_regen <= 0 or n_free * cfg.lazy_regen >= p
                    or 0 < remaining <= n_free):
                n_new = max(min(n_free, remaining), 0)
        n_live = n_alive + n_new

        def rung(rungs, n):
            if n == 0:
                return 0
            return rungs[bisect.bisect_left(rungs, n)] if sorted_now else p
        return (n_new, rung(self.regen_rungs, n_new),
                rung(self.trace_rungs, n_live), n_pending + n_new > 0)

    # -- stage B: regen, park, trace and shade ---------------------------

    def _n_new(self):
        """The work items regen injects, on the device (``plan``'s
        rule)."""
        st, cfg, p = self.st, self.cfg, self.p
        n_free = st["counts"][2]
        remaining = self.total - st["next_work"]
        n_new = torch.clamp(torch.minimum(n_free, remaining), min=0)
        if cfg.lazy_regen > 0:
            do = ((n_free * cfg.lazy_regen >= p)
                  | ((remaining > 0) & (remaining <= n_free)))
            n_new = torch.where(do, n_new, 0)
        return n_new

    def stage_b(self, sorted_now: bool, regen: int, trace: int):
        """Regen into the window of ``regen`` lanes (none where 0), park
        the dead lanes, trace and shade [0, ``trace``)."""
        st, p = self.st, self.p
        tracing.stamp(st["counts"], "gap")
        n_live = st["counts"][0]
        if regen:
            n_new = self._n_new()
            lanes = None
            if sorted_now:
                start = torch.clamp(n_live, max=p - regen)
                lanes = start + torch.arange(regen, device=start.device)
            self._regen(lanes, n_new)
            st["next_work"] += n_new
            n_live = n_live + n_new

        # Park dead lanes: every slab test fails for them.
        dead = ~st["alive"]
        st["origin"].masked_fill_(dead[:, None], 1e30)
        st["direction"].masked_fill_(dead[:, None], 1.0)
        st["rays"] += n_live
        st["it"] += 1
        tracing.stamp(st["counts"], "regen")

        # Trace + shade the window [0, trace): it holds the alive lanes
        # (a prefix after a sort; the full pool otherwise).  Tile
        # boundaries match the full dispatch, so results are the same.
        if trace:
            self._trace(trace)

    def _regen(self, lanes, n_new):
        """Refill the first n_new free lanes (in lane order) of the window
        ``lanes`` (an index tensor; None: the whole pool) with work
        items next_work + rank."""
        st, cfg = self.st, self.cfg

        def get(k):
            return st[k] if lanes is None else _rows(st[k], lanes)

        free = ~get("alive") & ~get("pending")
        rank = torch.cumsum(free, 0) - 1
        valid = free & (rank < n_new)
        item = st["next_work"] + rank
        sampi = torch.where(valid, item // self.npix, 0)
        pixi = torch.where(valid, item % self.npix, 0)
        px, py = self.pix_coords(pixi)
        pxy = torch.stack([px, py], -1)
        nseed = seed_from_pixel(_rows(self.seeds, sampi), pxy,
                                parity=cfg.parity_rng)
        o_new, d_new, nseed = generate_ray(
            self.cam, None, pxy, None, nseed, rand=get_rand(cfg.parity_rng),
            consts=self.consts)
        v3 = valid[:, None]
        new = dict(origin=torch.where(v3, o_new, get("origin")),
                   direction=torch.where(v3, d_new, get("direction")),
                   mask=torch.where(v3, 1.0, get("mask")),
                   acc=torch.where(v3, 0.0, get("acc")),
                   seed=torch.where(v3, nseed, get("seed")),
                   bounce=torch.where(valid, 0, get("bounce")),
                   pixid=torch.where(valid, pixi.to(torch.int32),
                                     get("pixid")),
                   alive=get("alive") | valid,
                   pending=get("pending") | valid,
                   prev_pdf=torch.where(valid, 0.0, get("prev_pdf")))
        for k, v in new.items():
            if lanes is None:
                st[k].copy_(v)
            else:
                st[k][lanes] = v

    def _trace(self, m: int):
        st, cfg = self.st, self.cfg
        sub = {k: st[k][:m] for k in _LANE_KEYS}
        t, obj, tri = self.isect(self.scene, sub["origin"],
                                 sub["direction"], eps=cfg.eps)
        tracing.stamp(st["counts"], "intersect")
        origin, direction, acc, mask, alive2, seed, prev_pdf = \
            shade_step(self.scene, cfg, sub["origin"], sub["direction"],
                       sub["acc"], sub["mask"], sub["alive"],
                       sub["seed"], sub["bounce"], t, obj, tri,
                       prev_pdf=sub["prev_pdf"], isect=self.isect,
                       counts=st["counts"])
        bounce = torch.where(sub["alive"], sub["bounce"] + 1,
                             sub["bounce"])
        sub["origin"].copy_(origin)
        sub["direction"].copy_(direction)
        sub["acc"].copy_(acc)
        sub["mask"].copy_(mask)
        sub["seed"].copy_(seed)
        sub["prev_pdf"].copy_(prev_pdf)
        sub["bounce"].copy_(bounce)
        sub["alive"].copy_(alive2 & (bounce < cfg.max_depth))
        tracing.stamp(st["counts"], "shade")

    # -- one iteration -------------------------------------------------------

    def _windows(self, sorted_now: bool):
        """Every (regen, trace) window pair stage B can take."""
        regen = (0, *self.regen_rungs) if sorted_now else (0, self.p)
        trace = self.trace_rungs if sorted_now else (self.p,)
        return [(0, 0)] + [(r, t) for r in regen for t in trace]

    def _run(self, graphs, key, fn):
        if graphs is None:
            fn()
            return
        stage = self.stages.get(key)
        if stage is not None:
            stage.replay()
            return
        self.stages[key] = graphs.capture(fn)
        if key[0] == "B" and key[2] and key[3]:
            # Its warm-up ran regen and trace: capture every other window
            # of the ladder now (a capture runs nothing), so that no later
            # iteration waits on a first use.
            sorted_now = key[1]
            for regen, trace in self._windows(sorted_now):
                k = ("B", sorted_now, regen, trace)
                if k not in self.stages:
                    self.stages[k] = graphs.capture(
                        lambda r=regen, t=trace: self.stage_b(sorted_now, r,
                                                              t),
                        warm_up=False)

    def __call__(self, graphs=None, drain: bool = False) -> bool:
        """One iteration, through ``graphs`` (a GraphCache) or eagerly
        (None); returns whether any lane is pending after it."""
        st, cfg = self.st, self.cfg
        if not cfg.sort_rays:
            mode = "unsorted"
        elif cfg.sort_every <= 1 or st["host_it"] % cfg.sort_every == 0:
            mode = "sort"
        else:
            mode = "none"
        self._run(graphs, ("A", mode), lambda: self.stage_a(mode))
        # The iteration's host read (the trace counts it with the call's
        # iterations), which brings the stopwatch's slots too.  A lane
        # stays pending until its flush, so pending lanes after this
        # iteration are the ones pending now plus the regenerated ones.
        with tracing.span("count_read"):
            counts = st["counts_read"] = st["counts"].tolist()
        n_new, regen, trace, any_pending = self.plan(
            counts[:tracing.COUNTS], drain, mode == "sort")
        key = ("B", mode == "sort", regen, trace)
        self._run(graphs, key,
                  lambda: self.stage_b(mode == "sort", regen, trace))
        st["host_next_work"] += n_new
        st["host_it"] += 1
        return any_pending


def _frame(cfg: RenderConfig, scene, npix_state: int, rows, y0: int):
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    npix = rows * w
    if npix_state != npix:
        raise ValueError(f"pool state npix {npix_state} != frame {npix}")
    blocked, bh, bw = pix_layout(cfg, scene, rows, w)
    return npix, (lambda pixi: _pix_coords(pixi, blocked, bh, bw, w, y0))


def _body(scene, cfg: RenderConfig, st, rows, y0: int, eager: bool):
    """(the loop body of pool ``st`` for the frame, the GraphCache to run
    it through or None).  On the card the body, with its input buffers
    and captured stages, is kept by the scene's cache."""
    npix, pix_coords = _frame(cfg, scene, st["accum"].shape[0], rows, y0)
    if not uses_graphs(cfg, scene, st["pixid"].device, eager):
        return _Body(scene, cfg, st, npix, pix_coords), None
    graphs = graph_cache(scene)
    key = (id(st), cfg, rows, y0)
    return graphs.keep(key, lambda: _Body(scene, cfg, st, npix,
                                          pix_coords)), graphs


def render_wavefront(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
                     pool: int = 1 << 20, flush_cap: int = 1 << 18,
                     y0: int = 0, rows: int | None = None,
                     _eager: bool = False):
    """Render ``S = len(ubo_seeds)`` samples of the row slab
    [y0, y0 + rows) (default: the full frame) in one fresh pool of
    ``min(pool, S * rows * W)`` lanes on ``cam_world``'s device, until
    every work item is issued and no lane is pending.  Pixel streams are
    keyed by absolute coordinates, so slabs tile back into the full
    frame (what ``parallel/mesh.py`` rests on).  ``flush_cap`` sizes a
    TPU flush window and is ignored.  On the card the pool of each
    (config, pool size, slab) is kept with its captured stages and
    emptied in place for the next call.

    Returns (radiance sum [rows, W, 3] over the S samples in row order,
    rays traced, iterations) — the last two as ints."""
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    npix = rows * w
    total = int(ubo_seeds.shape[0]) * npix
    p = min(pool, total)
    dev = cam_world.device
    if uses_graphs(cfg, scene, dev, _eager):
        state = graph_cache(scene).keep(
            ("render_wavefront", cfg, p, rows, y0),
            lambda: wavefront_pool_state(p, npix, dev))
        reset_pool_state(state)
    else:
        state = wavefront_pool_state(p, npix, dev)
    body, graphs = _body(scene, cfg, state, rows, y0, _eager)
    body.set_inputs(cam_world, fov_y, ubo_seeds)
    max_iters = (((total // p + 3) * cfg.max_depth + 4)
                 * max(cfg.sort_every, 1) + 4 * max(cfg.lazy_regen, 1))
    pending = False
    while ((state["host_next_work"] < total or pending)
           and state["host_it"] < max_iters):
        pending = body(graphs)
    _flush_unsorted(state)
    tracing.loop_call(state)
    blocked, bh, bw = pix_layout(cfg, scene, rows, w)
    tracing.host_sync("fold")
    return (unblock_accum(state["accum"].clone(), blocked, bh, bw, rows, w),
            int(state["rays"]), state["host_it"])


def wavefront_chunk(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
                    state, y0: int = 0, rows: int | None = None,
                    _eager: bool = False):
    """Advance a persistent pool by one chunk of ``S = len(ubo_seeds)``
    samples: iterate until every work item of the chunk is injected;
    in-flight paths stay in ``state`` (updated in place and returned)
    for the next chunk or ``wavefront_drain``.  cam_world: [4, 4]
    tensor on the pool's device; ubo_seeds: [S, 2] integer tensor."""
    body, graphs = _body(scene, cfg, state, rows, y0, _eager)
    body.set_inputs(cam_world, fov_y, ubo_seeds)
    total = body.total_host
    p = body.p
    max_iters = (((total // p + 3) * (cfg.max_depth + 2))
                 * max(cfg.sort_every, 1) + 4 * max(cfg.lazy_regen, 1))
    state["next_work"].zero_()
    state["it"].zero_()
    state["host_next_work"] = state["host_it"] = 0
    while state["host_next_work"] < total and state["host_it"] < max_iters:
        body(graphs)
    tracing.loop_call(state)
    return state


def wavefront_drain(scene, cfg: RenderConfig, state, y0: int = 0,
                    rows: int | None = None, _eager: bool = False):
    """Trace a persistent pool to completion without injecting work;
    afterwards every injected path's radiance is in ``state['accum']``."""
    body, graphs = _body(scene, cfg, state, rows, y0, _eager)
    max_iters = (cfg.max_depth + 2) * max(cfg.sort_every, 1) + 8
    state["it"].zero_()
    state["host_it"] = 0
    tracing.host_sync("drain")
    pending = bool(state["pending"].any())
    while pending and state["host_it"] < max_iters:
        pending = body(graphs, drain=True)
    # A final flush (a no-op unless max_iters cut the loop short).
    _flush_unsorted(state)
    tracing.loop_call(state)
    return state
