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
     counter ``shadow_rays``).

The loop runs in Python.  Its host reads — the alive and pending counts
after each flush (regen start, trace window, ray counter, the loop
tests) — are one device sync per iteration.  After a sort the alive
lanes form a prefix, so regen writes plain slices at ``n_alive`` and
steps 4-5 run on the smallest whole-tile window covering it; the JAX package's
regen and trace "ladders" exist only because XLA needs static shapes,
and give the same lanes the same values.

Per-(pixel, sample) RNG streams and draw order equal the JAX package's,
so each work item's radiance matches up to intersect near-ties and the
last ulps of the device libm.  ``pool_cm`` and ``sort_variadic`` choose
TPU layouts and are ignored; ``sort_rays``, ``sort_every``,
``lazy_regen`` and ``max_depth`` are honoured.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.camera import generate_ray
from logipathtracer_tpu_torch.ops.kernels.flush import flush_sorted
from logipathtracer_tpu_torch.ops.rng import get_rand, seed_from_pixel
from logipathtracer_tpu_torch.render.megakernel import (intersect_tile,
                                                        pick_intersect,
                                                        ray_sort_key,
                                                        shade_step)

_LANE_KEYS = ("origin", "direction", "mask", "acc", "seed", "alive",
              "pending", "prev_pdf", "bounce", "pixid")


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
    """Fresh pool: every lane free, zero accumulation.  Lane state lives
    in tensors; the counters (``next_work``, ``rays``, ``it``) are
    python ints, except ``shadow_rays`` (NEE), a device scalar."""
    dev = torch.device(device)
    direction = torch.zeros((p, 3), device=dev)
    direction[:, 2] = 1.0
    return dict(
        origin=torch.zeros((p, 3), device=dev),
        direction=direction,
        mask=torch.ones((p, 3), device=dev),
        acc=torch.zeros((p, 3), device=dev),
        seed=torch.zeros((p, 2), dtype=torch.int64, device=dev),
        alive=torch.zeros((p,), dtype=torch.bool, device=dev),
        pending=torch.zeros((p,), dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros((p,), device=dev),
        bounce=torch.zeros((p,), dtype=torch.int32, device=dev),
        pixid=torch.zeros((p,), dtype=torch.int32, device=dev),
        next_work=0,
        accum=torch.zeros((npix, 3), device=dev),
        rays=0,
        shadow_rays=torch.zeros((), dtype=torch.int64, device=dev),
        it=0,
    )


def _flush_unsorted(st):
    """Flush retired lanes wherever they sit: order them by pixel id
    (stable, so one pixel's rows keep lane order — the scatter order of
    the reference) and run the sorted flush."""
    flush = st["pending"] & ~st["alive"]
    key = torch.where(flush, st["pixid"], -1)
    key, perm = torch.sort(key, stable=True)
    flush_sorted(st["accum"], key.to(torch.int32).contiguous(),
                 st["acc"][perm].contiguous())
    st["pending"] = st["pending"] & ~flush


class _Body:
    """One wavefront iteration for a fixed (scene, config, frame)."""

    def __init__(self, scene, cfg: RenderConfig, cam_world, fov_y,
                 ubo_seeds, p: int, npix: int, total: int, pix_coords):
        self.scene = scene
        self.cfg = cfg
        self.cam_world = cam_world
        self.fov_y = fov_y
        self.ubo_seeds = ubo_seeds
        self.p = p
        self.npix = npix
        self.total = total
        self.pix_coords = pix_coords
        self.isect = pick_intersect(cfg, scene)
        self.tile = intersect_tile(cfg, scene)

    def _sort_and_flush(self, st):
        alive, pending = st["alive"], st["pending"]
        retired = pending & ~alive
        key = torch.where(
            alive, ray_sort_key(self.scene, st["origin"], st["direction"]),
            torch.where(retired, (1 << 18) + 1 + st["pixid"], 1 << 18))
        _, perm = torch.sort(key, stable=True)
        for k in _LANE_KEYS:
            st[k] = st[k][perm]
        # Retired lanes now form the tail, ascending by pixel id.
        flush = st["pending"] & ~st["alive"]
        flush_sorted(st["accum"],
                     torch.where(flush, st["pixid"], -1).to(torch.int32),
                     st["acc"])
        st["pending"] = st["pending"] & ~flush

    def _regen(self, st, lanes, n_free: int):
        cfg = self.cfg
        n_new = lanes.shape[0]
        if n_new:
            dev = lanes.device
            item = st["next_work"] + torch.arange(n_new, device=dev)
            sampi = item // self.npix
            pixi = item % self.npix
            px, py = self.pix_coords(pixi)
            pxy = torch.stack([px, py], -1)
            nseed = seed_from_pixel(self.ubo_seeds[sampi], pxy,
                                    parity=cfg.parity_rng)
            o_new, d_new, nseed = generate_ray(
                self.cam_world, self.fov_y, pxy,
                (cfg.render_width, cfg.render_height), nseed,
                rand=get_rand(cfg.parity_rng))
            st["origin"][lanes] = o_new
            st["direction"][lanes] = d_new
            st["mask"][lanes] = 1.0
            st["acc"][lanes] = 0.0
            st["seed"][lanes] = nseed
            st["bounce"][lanes] = 0
            st["pixid"][lanes] = pixi.to(torch.int32)
            st["alive"][lanes] = True
            st["pending"][lanes] = True
            st["prev_pdf"][lanes] = 0.0
        st["next_work"] = min(st["next_work"] + n_free, self.total)

    def __call__(self, st, drain: bool = False) -> bool:
        """One iteration; returns whether any lane is pending after it."""
        cfg = self.cfg
        p = self.p
        sorted_now = False
        if cfg.sort_rays:
            if cfg.sort_every <= 1 or st["it"] % cfg.sort_every == 0:
                self._sort_and_flush(st)
                sorted_now = True
        else:
            _flush_unsorted(st)

        # The iteration's host read.  A lane stays pending until its
        # flush, so pending lanes after this iteration are the ones
        # pending now plus the regenerated ones.
        n_alive, n_pending = torch.stack(
            (st["alive"].sum(), st["pending"].sum())).tolist()
        n_new = 0
        if not drain:
            if sorted_now:
                n_free = p - n_alive   # free lanes are [n_alive, p)
            else:
                free = ~st["alive"] & ~st["pending"]
                n_free = int(free.sum())
            remaining = self.total - st["next_work"]
            do_regen = (cfg.lazy_regen <= 0
                        or n_free * cfg.lazy_regen >= p
                        or 0 < remaining <= n_free)
            if do_regen:
                n_new = max(min(n_free, remaining), 0)
                dev = st["alive"].device
                if sorted_now:
                    lanes = torch.arange(n_alive, n_alive + n_new,
                                         device=dev)
                else:
                    lanes = free.nonzero().squeeze(1)[:n_new]
                self._regen(st, lanes, n_free)
                n_alive += n_new
        any_pending = n_pending + n_new > 0

        # Park dead lanes: every slab test fails for them.
        dead = ~st["alive"]
        st["origin"].masked_fill_(dead[:, None], 1e30)
        st["direction"].masked_fill_(dead[:, None], 1.0)
        st["rays"] += n_alive

        # Trace + shade the smallest whole-tile window holding the alive
        # lanes (a prefix after a sort; the full pool otherwise).  Tile
        # boundaries match the full dispatch, so results are the same.
        m = p
        if sorted_now:
            m = min(p, -(-n_alive // self.tile) * self.tile)
        if n_alive and m:
            sub = {k: st[k][:m] for k in _LANE_KEYS}
            t, obj, tri = self.isect(self.scene, sub["origin"],
                                     sub["direction"], eps=cfg.eps)
            origin, direction, acc, mask, alive2, seed, prev_pdf = \
                shade_step(self.scene, cfg, sub["origin"], sub["direction"],
                           sub["acc"], sub["mask"], sub["alive"],
                           sub["seed"], sub["bounce"], t, obj, tri,
                           prev_pdf=sub["prev_pdf"], isect=self.isect,
                           shadow_count=st["shadow_rays"])
            bounce = torch.where(sub["alive"], sub["bounce"] + 1,
                                 sub["bounce"])
            st["origin"][:m] = origin
            st["direction"][:m] = direction
            st["acc"][:m] = acc
            st["mask"][:m] = mask
            st["seed"][:m] = seed
            st["prev_pdf"][:m] = prev_pdf
            st["bounce"][:m] = bounce
            st["alive"][:m] = alive2 & (bounce < cfg.max_depth)
        st["it"] += 1
        return any_pending


def _frame(cfg: RenderConfig, scene, npix_state: int, rows, y0: int):
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    npix = rows * w
    if npix_state != npix:
        raise ValueError(f"pool state npix {npix_state} != frame {npix}")
    blocked, bh, bw = pix_layout(cfg, scene, rows, w)
    return npix, (lambda pixi: _pix_coords(pixi, blocked, bh, bw, w, y0))


def render_wavefront(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
                     pool: int = 1 << 20, flush_cap: int = 1 << 18,
                     y0: int = 0, rows: int | None = None):
    """Render ``S = len(ubo_seeds)`` samples of the row slab
    [y0, y0 + rows) (default: the full frame) in one fresh pool of
    ``min(pool, S * rows * W)`` lanes on ``cam_world``'s device, until
    every work item is issued and no lane is pending.  Pixel streams are
    keyed by absolute coordinates, so slabs tile back into the full
    frame (what ``parallel/mesh.py`` rests on).  ``flush_cap`` sizes a
    TPU flush window and is ignored.

    Returns (radiance sum [rows, W, 3] over the S samples in row order,
    rays traced, iterations) — the last two as ints."""
    h, w = cfg.render_height, cfg.render_width
    rows = h if rows is None else rows
    npix = rows * w
    total = int(ubo_seeds.shape[0]) * npix
    p = min(pool, total)
    state = wavefront_pool_state(p, npix, cam_world.device)
    _, pix_coords = _frame(cfg, scene, npix, rows, y0)
    body = _Body(scene, cfg, cam_world, fov_y, ubo_seeds.to(torch.int64),
                 p, npix, total, pix_coords)
    max_iters = (((total // p + 3) * cfg.max_depth + 4)
                 * max(cfg.sort_every, 1) + 4 * max(cfg.lazy_regen, 1))
    pending = False
    while ((state["next_work"] < total or pending)
           and state["it"] < max_iters):
        pending = body(state)
    _flush_unsorted(state)
    blocked, bh, bw = pix_layout(cfg, scene, rows, w)
    return (unblock_accum(state["accum"], blocked, bh, bw, rows, w),
            state["rays"], state["it"])


def wavefront_chunk(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seeds,
                    state, y0: int = 0, rows: int | None = None):
    """Advance a persistent pool by one chunk of ``S = len(ubo_seeds)``
    samples: iterate until every work item of the chunk is injected;
    in-flight paths stay in ``state`` (updated in place and returned)
    for the next chunk or ``wavefront_drain``.  cam_world: [4, 4]
    tensor on the pool's device; ubo_seeds: [S, 2] integer tensor."""
    npix, pix_coords = _frame(cfg, scene, state["accum"].shape[0], rows, y0)
    p = state["pixid"].shape[0]
    total = int(ubo_seeds.shape[0]) * npix
    body = _Body(scene, cfg, cam_world, fov_y,
                 ubo_seeds.to(torch.int64), p, npix, total, pix_coords)
    max_iters = (((total // p + 3) * (cfg.max_depth + 2))
                 * max(cfg.sort_every, 1) + 4 * max(cfg.lazy_regen, 1))
    state["next_work"] = 0
    state["it"] = 0
    while state["next_work"] < total and state["it"] < max_iters:
        body(state)
    return state


def wavefront_drain(scene, cfg: RenderConfig, state, y0: int = 0,
                    rows: int | None = None):
    """Trace a persistent pool to completion without injecting work;
    afterwards every injected path's radiance is in ``state['accum']``."""
    npix, pix_coords = _frame(cfg, scene, state["accum"].shape[0], rows, y0)
    p = state["pixid"].shape[0]
    body = _Body(scene, cfg, None, None, None, p, npix, 0, pix_coords)
    max_iters = (cfg.max_depth + 2) * max(cfg.sort_every, 1) + 8
    state["it"] = 0
    pending = bool(state["pending"].any())
    while pending and state["it"] < max_iters:
        pending = body(state, drain=True)
    # A final flush (a no-op unless max_iters cut the loop short).
    _flush_unsorted(state)
    return state
