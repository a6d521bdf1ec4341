"""What ``chip_smoke.py`` and ``tools/kernel_times.py`` share: the main
paths' ray pools, a runner per intersect kernel with its front end and
the intersect kernels' count pass, the K3 input tail, K2's pools and its
count pass, the texture prologue's pool, comparison and bytes, and the
timers.

The module imports no part of the package at its top: each function
imports what it needs when called, so ``tools/kernel_times.py --root``
builds the same inputs with another checkout's package.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

EPS = 1e-4


def event_ms(fn, runs: int = 10) -> float:
    """The median of ``runs`` single calls, each between two CUDA
    events."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, n):
    """(device ms, stream ms, host µs) of one call: the kernel rows of
    ``torch.profiler`` over n calls, divided by n — the device's own
    time, whatever the host takes between launches — then n calls back
    to back between two events, divided by n, and the host's time to
    issue them, divided by n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    assert dev_us > 0, "the profiler recorded no device time"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return dev_us / 1e3 / n, start.elapsed_time(end) / n, host_s / n * 1e6


def make_tail(npix, rows, retired, dev, seed=0):
    """K3's input, a sorted pool tail: -1 prefix, then `retired`
    ascending pixel ids (with repeats, as several samples of one pixel
    retire together), and each row's radiance."""
    rng = np.random.default_rng(seed)
    pix = np.sort(rng.integers(0, npix, retired)).astype(np.int32)
    pix = np.concatenate([np.full(rows - retired, -1, np.int32), pix])
    acc = rng.random((rows, 3), dtype=np.float32)
    return (torch.from_numpy(pix).to(dev), torch.from_numpy(acc).to(dev))


def primary_pool(renderer, seed_xy=(48271, 16807)):
    """The main path's first pool: every pixel's sample-0 camera ray in
    the block-major order regen injects them."""
    from logipathtracer_tpu_torch.ops.camera import generate_ray
    from logipathtracer_tpu_torch.ops.rng import get_rand, seed_from_pixel
    from logipathtracer_tpu_torch.render.wavefront import (_pix_coords,
                                                           pix_layout)
    cfg, dev = renderer.config, renderer.device
    h, w = cfg.render_height, cfg.render_width
    blocked, bh, bw = pix_layout(cfg, renderer.scene, h, w)
    pixi = torch.arange(min(cfg.pool_size, h * w), device=dev)
    px, py = _pix_coords(pixi, blocked, bh, bw, w, 0)
    pxy = torch.stack([px, py], -1)
    seed = seed_from_pixel(torch.tensor(seed_xy, device=dev), pxy,
                           parity=cfg.parity_rng)
    cam = torch.from_numpy(renderer.camera_world).to(dev)
    return generate_ray(cam, renderer.fov_y, pxy, (w, h), seed,
                        rand=get_rand(cfg.parity_rng))


def bounce_pool(renderer):
    """A mid-render pool: the renderer's state after one step, alive
    lanes sorted first by coherence key, dead lanes parked — what the
    next iteration's intersect sees."""
    from logipathtracer_tpu_torch.render.megakernel import ray_sort_key
    renderer.step(1)
    st = renderer._wf_state
    key = torch.where(st["alive"],
                      ray_sort_key(renderer.scene, st["origin"],
                                   st["direction"]), 1 << 18)
    _, perm = torch.sort(key, stable=True)
    pool = {k: st[k][perm].clone() for k in
            ("origin", "direction", "mask", "acc", "seed", "alive",
             "bounce", "prev_pdf")}
    dead = ~pool["alive"]
    pool["origin"][dead] = 1e30
    pool["direction"][dead] = 1.0
    return pool


def shadow_pool(renderer):
    """The NEE shadow rays of ``bounce_pool`` (a renderer with nee and no
    textures): K2's shadow origin, direction and t_max per lane, and the
    bounce pool's alive lanes."""
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.render.megakernel import pick_intersect
    cfg, scene = renderer.config, renderer.scene
    pool = bounce_pool(renderer)
    t, _, tri = pick_intersect(cfg, scene)(scene, pool["origin"],
                                           pool["direction"], cfg.eps)
    out = sk.shade(scene.tri_shade, pool["origin"], pool["direction"],
                   pool["acc"], pool["mask"], pool["alive"], pool["seed"],
                   pool["bounce"], t, tri, env=cfg.env_color,
                   rr_threshold=cfg.rr_threshold, rr_bounces=cfg.rr_bounces,
                   max_order=cfg.heitz_max_order, parity=cfg.parity_rng,
                   light_tris=scene.light_tris, light_cdf=scene.light_cdf,
                   prev_pdf=pool["prev_pdf"], nee_mis=cfg.nee_mis,
                   total_light_area=float(scene.total_light_area))
    return out[7], out[8], out[9], int(pool["alive"].sum())


def pools(host, cfg, dev, tile):
    """{"primary", "bounce", "shadow"}: (rays8 [8, pool] packed in
    ``tile``-ray tiles, kwargs of the intersect mode) on ``host`` under
    ``cfg`` — ``primary_pool``, ``bounce_pool`` and (with nee)
    ``shadow_pool`` of host seed 1."""
    from logipathtracer_tpu_torch import ProgressiveRenderer
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    probe = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
    o, d, _ = primary_pool(probe)
    out = {"primary": (ci.pack_rays8(o, d, tile)[0], {})}
    pool = bounce_pool(probe)
    out["bounce"] = (ci.pack_rays8(pool["origin"], pool["direction"],
                                   tile)[0], {})
    probe = ProgressiveRenderer(host, cfg.replace(nee=True), host_seed=1,
                                device=dev)
    so, sd, t_max, _ = shadow_pool(probe)
    out["shadow"] = (ci.pack_rays8(so, sd, tile, t_max=t_max)[0],
                     dict(has_tmax=True, any_hit=True))
    return out


def _megakernel_bounce(renderer, seed_xy, bounces=1):
    """The megakernel's first bounces at the renderer's size, as
    ``trace_rays`` makes them: (the primary rays, the parked rays of
    bounce ``bounces``, that bounce's pool and hits)."""
    from logipathtracer_tpu_torch.render import megakernel as mk
    cfg, dev, scene = renderer.config, renderer.device, renderer.scene
    pix, _ = mk.block_pixels(cfg, scene, 0, cfg.render_height, dev)
    cam = torch.from_numpy(renderer.camera_world).to(dev)
    o, d, seed = mk.camera_rays(cfg, cam, renderer.fov_y,
                                torch.tensor(seed_xy, device=dev), pix)
    o, d = o.contiguous(), d.contiguous()
    isect = mk.pick_intersect(cfg, scene)
    n = o.shape[0]
    t, obj, tri = mk.sorted_intersect(isect, scene, o, d, cfg.eps)
    state = (o, d, torch.zeros_like(o), torch.ones_like(o),
             torch.ones(n, dtype=torch.bool, device=dev), seed, None)
    for b in range(bounces):
        o1, d1, acc, mask, alive, seed, prev = mk.shade_step(
            scene, cfg, *state[:6], b, t, obj, tri, prev_pdf=state[6])
        state = (o1, d1, acc, mask, alive, seed, prev)
        oi = torch.where(alive[:, None], o1, 1e30)
        di = torch.where(alive[:, None], d1, 1.0)
        t, obj, tri = mk.sorted_intersect(isect, scene, oi, di, cfg.eps)
    pool = dict(zip(("origin", "direction", "acc", "mask", "alive", "seed",
                     "prev_pdf"), state))
    pool["bounce"] = torch.full((n,), bounces, dtype=torch.int32,
                                device=dev)
    return (o, d), (oi, di), pool, t, tri


def megakernel_shade_args(renderer, bounce=4, seed_xy=(48271, 16807)):
    """(args, kwargs) of the megakernel's K2 call at bounce ``bounce``
    (default the fifth, after two of Russian roulette): every pixel in
    the route's block-major order, the lanes dead by then among the
    live ones (``trace_rays`` shades the whole frame every bounce)."""
    cfg = renderer.config
    _, _, pool, t, tri = _megakernel_bounce(renderer, seed_xy, bounce)
    return shade_args(renderer.scene, cfg, pool, t.contiguous(),
                      tri.to(torch.int32).contiguous(), cfg.parity_rng)


def megakernel_pools(renderer, seed_xy=(48271, 16807)):
    """The megakernel's intersect inputs at the renderer's size: the
    primary pool (every pixel's camera ray in the route's block-major
    order, sorted by coherence key as sorted_intersect sorts them), the
    pool of the second bounce (dead lanes parked, sorted) and that
    bounce's NEE shadow pool (shadow rays in pixel order, through the
    unsorted closure as trace_rays casts them).  Each is (origin,
    direction[, t_max]); then the second bounce's alive lanes."""
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    from logipathtracer_tpu_torch.render import megakernel as mk
    cfg, scene = renderer.config, renderer.scene
    (o, d), (oi, di), pool, t, tri = _megakernel_bounce(renderer, seed_xy)

    def in_key_order(o, d):
        _, perm = torch.sort(mk.ray_sort_key(scene, o, d), stable=True)
        return o[perm].contiguous(), d[perm].contiguous()

    args, kw = shade_args(scene, cfg, pool, t, tri, cfg.parity_rng, dict(
        light_tris=scene.light_tris, light_cdf=scene.light_cdf,
        prev_pdf=pool["prev_pdf"], nee_mis=cfg.nee_mis,
        total_light_area=float(scene.total_light_area)))
    out = sk.shade(*args, **kw)
    return (in_key_order(o, d), in_key_order(oi, di),
            (out[7].contiguous(), out[8].contiguous(), out[9].contiguous()),
            int(pool["alive"].sum()))


def scene_tables(scene):
    """(cl_meta, cl_inv, cl_aabb, cl_tris): the intersect kernels' scene
    inputs, cl_inv the objects' 3x4 inverse rows."""
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    return scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris


def runner(kind, scene, rays8, tile, chunk=16, **kw):
    """(kernel call, plain call, inputs, wn) of one intersect kernel — K1
    and the streamed (K4, K5, K6) or order (K7, K8) kinds — on a packed
    pool, with the front end the main path gives it, computed once (wn
    [tiles]: the clusters, for K5 and K6 the chunks, each tile lists —
    its worklist, or every one, none on a K6 tile with live == 0; K4's
    call takes the scene's 32-slot groups where the package has them)."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    from logipathtracer_tpu_torch.ops.traverse import (scene_chunk_bounds,
                                                       scene_cluster_bounds)
    tables = scene_tables(scene)
    has_tmax = kw.get("has_tmax", False)
    if kind in ("K7", "K8"):
        args = (rays8, ci.tile_octants(rays8, tile), scene.cl_order, *tables,
                tile, EPS)
        kernel, plain = ((ci.compact_order_intersect,
                          ci.compact_order_intersect_plain) if kind == "K7"
                         else (k6.dense_sweep_intersect,
                               k6.dense_sweep_intersect_plain))
        wn = torch.full((rays8.shape[1] // tile,), scene.cl_tris.shape[0],
                        dtype=torch.int32, device=rays8.device)
        return (lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                args[:7], wn)
    if kind in ("K1", "K4"):
        build, kernel, plain = (
            (ci.build_chunk_worklists, ci.compact_wl_intersect,
             ci.compact_wl_intersect_plain) if kind == "K1" else
            (k4.build_cluster_worklists, k4.stream_cl_intersect,
             k4.stream_cl_intersect_plain))
        wl, wn = build(*scene_cluster_bounds(scene), rays8, tile,
                       has_tmax=has_tmax)
        args = (rays8, wl, wn, *tables, tile, EPS)
        kernel_kw = dict(kw)
        if kind == "K4" and hasattr(k4, "cluster_groups"):
            from logipathtracer_tpu_torch.ops.traverse import \
                scene_cluster_groups
            kernel_kw["groups"] = scene_cluster_groups(scene)
        return (lambda: kernel(*args, **kernel_kw),
                lambda: plain(*args, **kw), args[:7], wn)
    bounds = scene_chunk_bounds(scene, chunk)
    chunk_aabb = torch.cat(bounds, 1).contiguous()
    if kind == "K5":
        wl, wn = ci.build_chunk_worklists(*bounds, rays8, tile,
                                          has_tmax=has_tmax)
        args = (rays8, wl, wn, chunk_aabb, *tables, tile, chunk, EPS)
        return (lambda: ci.worklist_chunk_intersect(*args, **kw),
                lambda: ci.worklist_chunk_intersect_plain(*args, **kw),
                args[:8], wn)
    oct_, live = k6.tile_front(rays8, tile)
    order = k6.octant_chunk_order(*bounds)
    args = (rays8, oct_, order, live, chunk_aabb, *tables, tile, chunk, EPS)
    kw = dict(kw, cap=0 if kind == "K6[cap=0]" else 32)
    return (lambda: k6.octant_chunk_intersect(*args, **kw),
            lambda: k6.octant_chunk_intersect_plain(*args, **kw), args[:9],
            live * order.shape[1])


@contextlib.contextmanager
def isect_counted(block=256, prefetch=False, chunk=16, early_exit=False,
                  groups=False):
    """The intersect kernels' count pass: the plain intersect versions
    run in the block with every cluster visit's lanes observed
    (``PlainSweep.lanes`` and ``visit``).  The dict it yields holds,
    after the block, "slab": the slab tests made (each visit's lanes,
    within its gate), "own": the lanes whose own slab test passed,
    "subtile": the lanes of the 128-ray sub-tiles some ray of which
    passed (visits with ``subtile``), and "tested": the lanes that run
    the triangle test, the sub-tile's for a visit with ``subtile``, else
    the own passes; and, per visit of a cluster by a tile, "listed": the
    ``block``-ray blocks that visit it (within the gate), "passed": those
    with some own pass, and "staged": the blocks whose visit stages the
    cluster (closest_hit.cuh compact_visit, subtile_visit) — some own
    pass, or with ``prefetch`` some pass ahead: the slab against the best
    before the previous cluster of the same visit (the first cluster of a
    tile, or of a ``chunk``-cluster chunk behind a gate, is staged on an
    own pass).  With ``early_exit`` (the sub-tile visit's exit after u),
    "rest": the (lane, slot) tests of the gated sub-tiles that go on past
    the u decision — u not rejected, or a best above kInf before the
    visit — else None.  With ``groups`` (K4's triangle test by 32-slot
    groups, closest_hit.cuh warp_groups; the package's
    ``stream_cluster.cluster_groups``) and where the package has them,
    per own pass: "group_tests", the boxes of the cluster's groups that
    hold real slots, "group_passed", those whose slab passes against the
    lane's best before the visit, and "group_slots", the slots of the
    groups the warp tests — every passed group, or with any-hit those up
    to the first holding an accepted slot; else None.  The sums stay on
    the device until the block ends: no host read per visit."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    plain = ci.PlainSweep
    make_groups = getattr(k4, "cluster_groups", None) if groups else None
    slab, gated, own, sub, tested, rest = [0], [], [], [], [], []
    listed, passed, staged = [], [], []
    g_tests, g_passed, g_slots = [], [], []
    last = {}

    class Counting(plain):
        def __init__(self, rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps,
                     best0):
            super().__init__(rays8, cl_meta, cl_inv, cl_aabb, cl_tris, eps,
                             best0)
            if make_groups is not None:
                self.groups = make_groups(cl_meta, cl_inv, cl_aabb, cl_tris)

        def lanes(self, sl, c, gate=None):
            lo, ld, hit = super().lanes(sl, c, gate)
            self.last = lo, ld, hit
            if gate is None:
                slab[0] += hit.numel()
            else:
                gated.append(gate.sum())
            own.append(hit.sum())
            if not isinstance(sl, slice) or hit.numel() % block:
                return lo, ld, hit          # not a tile of K1, K4-K8
            g = torch.ones_like(hit) if gate is None else gate
            listed.append(g.reshape(-1, block).any(dim=1).sum())
            passed.append(hit.reshape(-1, block).any(dim=1).sum())
            key = (id(self), sl.start)
            ahead = hit
            if prefetch and last.get("key") == key and not (
                    gate is not None and c % chunk == 0):
                ahead = ci._slab_table(lo, [1.0 / x for x in ld],
                                       self.aabb[c], last["best"]) & g
            staged.append(ahead.reshape(-1, block).any(dim=1).sum())
            last.update(key=key, best=self.best_t[sl].clone())
            return lo, ld, hit

        def visit(self, sl, c, any_hit=False, gate=None, subtile=0):
            best = self.best_t[sl].clone()
            super().visit(sl, c, any_hit=any_hit, gate=gate,
                          subtile=subtile)
            lo, ld, hit = self.last
            if not subtile:
                tested.append(hit.sum())
                if make_groups is not None:
                    self.count_groups(lo, ld, hit, best, c, any_hit)
                return
            lanes = hit.reshape(-1, subtile).any(dim=1).repeat_interleave(
                subtile)
            n = lanes.sum()
            sub.append(n)
            tested.append(n)
            if early_exit:
                rest.append(past_u(lo, ld, lanes, self.cl_tris[c], best))

        def count_groups(self, lo, ld, hit, best, c, any_hit):
            """The group counts of one visit's own passes (warp_groups:
            the boxes of groups past the count are NaN and never pass)."""
            box, n = self.groups[0][c], self.groups[1][c]
            s = self.cl_tris.shape[2]
            gs = box.shape[0]
            width = (s - 32 * torch.arange(gs, device=box.device)).clamp(
                max=32)
            idx = hit.nonzero().squeeze(1)
            g_tests.append(idx.numel() * n)
            for part in idx.split(ci.MT_RAYS):
                pl = [x[part, None] for x in lo]
                pd = [x[part, None] for x in ld]
                gp = ci._slab_table(pl, [1.0 / x for x in pd],
                                    list(box[:, :6].T), best[part, None])
                g_passed.append(gp.sum())
                if any_hit:
                    t = ci._mt([x[:, 0] for x in pl], [x[:, 0] for x in pd],
                               self.cl_tris[c])
                    ok = (t > self.eps) & (t < best[part, None])
                    ok = torch.nn.functional.pad(ok, (0, 32 * gs - s))
                    stop = gp & ok.reshape(-1, gs, 32).any(dim=2)
                    first = torch.where(stop.any(dim=1),
                                        stop.int().argmax(dim=1), gs)
                    gp = gp & (torch.arange(gs, device=gp.device)[None]
                               <= first[:, None])
                g_slots.append((gp * width).sum())

    work = {}
    ci.PlainSweep = Counting
    try:
        yield work
    finally:
        ci.PlainSweep = plain
    total = lambda xs: int(torch.stack(xs).sum()) if xs else 0
    counted_groups = make_groups is not None
    work["slab"] = slab[0] + total(gated)
    work.update(own=total(own), subtile=total(sub), tested=total(tested),
                listed=total(listed), passed=total(passed),
                staged=total(staged),
                rest=total(rest) if early_exit else None,
                group_tests=total(g_tests) if counted_groups else None,
                group_passed=total(g_passed) if counted_groups else None,
                group_slots=total(g_slots) if counted_groups else None)


def past_u(lo, ld, lanes, trib, best):
    """The (lane, slot) tests of one cluster visit that an exact early
    exit after the u decision cannot leave: every slot of a ``lanes``
    lane whose u is not rejected (a NaN u is not), and every slot of a
    lane whose best is above kInf (it may accept a miss's kInf).  A 0-d
    tensor."""
    from logipathtracer_tpu_torch.ops.intersect import INF
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    idx = lanes.nonzero().squeeze(1)
    n = torch.zeros((), dtype=torch.int64, device=best.device)
    for part in idx.split(ci.MT_RAYS):
        u = ci._mt_u([x[part] for x in lo], [x[part] for x in ld], trib)[4]
        go_on = ~((u < 0.0) | (u > 1.0)) | (best[part] > INF)[:, None]
        n = n + go_on.sum()
    return n


def group_line(work) -> str:
    """The count pass's group figures (``isect_counted`` with
    ``groups``): the share of K4's group box tests that pass and the
    slots tested per queued ray (each own pass is a queued ray)."""
    if work.get("group_tests") is None:
        return "no group test"
    own = max(work["own"], 1)
    return (f"{work['group_tests']} group box tests "
            f"({work['group_tests'] / own:.2f} a queued ray), "
            f"{work['group_passed'] / max(work['group_tests'], 1):.4f} "
            f"passed; {work['group_slots'] / own:.1f} slots tested a "
            f"queued ray")


def sub_pool(rays8, tile, n_live, tiles):
    """``tiles`` whole tiles of rays8, evenly spread over the tiles that
    hold the first ``n_live`` lanes."""
    total = rays8.shape[1] // tile
    n = min(tiles, total)
    live = min(total, max(-(-n_live // tile), n))
    pick = torch.linspace(0, live - 1, n).round().long()
    idx = (pick[:, None] * tile + torch.arange(tile)).reshape(-1)
    return rays8[:, idx.to(rays8.device)].contiguous()


def timed_steps(renderer, timed=(2, 2)):
    """A warm-up step(1), then the timed steps: returns (samples/s,
    Mrays/s, iterations per timed step, radiance)."""
    renderer.step(1)
    torch.cuda.synchronize()
    rays0 = renderer.total_rays
    t0 = time.perf_counter()
    iters = []
    for n in timed:
        renderer.step(n)
        iters.append(renderer.last_iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = renderer.total_rays - rays0
    return sum(timed) / wall, rays / wall / 1e6, iters, renderer.radiance()


# ---- K2 (the shade kernel) ---------------------------------------------

def shade_args(scene, cfg, pool, t, tri, parity, opt=None):
    """(args, kwargs) of one ``shade`` / ``shade_plain`` call on a pool
    (a dict of origin, direction, acc, mask, alive, seed, bounce) with
    its hits; ``opt`` adds the texture / NEE inputs."""
    args = (scene.tri_shade, pool["origin"], pool["direction"], pool["acc"],
            pool["mask"], pool["alive"], pool["seed"], pool["bounce"], t,
            tri)
    kw = dict(env=cfg.env_color, rr_threshold=cfg.rr_threshold,
              rr_bounces=cfg.rr_bounces, max_order=cfg.heitz_max_order,
              parity=parity, **(opt or {}))
    return args, kw


def tex_pool(host, cfg, dev):
    """The texture prologue's inputs on a textured host scene compiled
    under ``cfg``: the bounce pool of a session (``bounce_pool``; 2^20
    lanes at 1024^2) with its hits: (scene, pool, t, obj, tri), the scene
    on ``dev``."""
    from logipathtracer_tpu_torch import ProgressiveRenderer
    from logipathtracer_tpu_torch.render.megakernel import pick_intersect
    probe = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
    pool = bounce_pool(probe)
    scene = probe.scene
    t, obj, tri = pick_intersect(cfg, scene)(scene, pool["origin"],
                                             pool["direction"], cfg.eps)
    return scene, pool, t, obj, tri


def tex_live(alive, t):
    """The prologue's live lanes: alive and a hit, K2's test."""
    from logipathtracer_tpu_torch.ops.intersect import INF
    return alive & ~(t >= INF)


def tex_agreement(got, ref, live):
    """(bit-equal, max |d|) of the prologue kernel's outputs ``got``
    against the plain version's ``ref``: mat on the live lanes and the
    mapped normal on the live lanes with a normal map, bit for bit, and
    zeros everywhere else, as the kernel writes them."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    mat, ffm, has = got
    pairs = [(mat[live], ref[0][live])]
    zeros = [mat[~live]]
    ok = ref[1] is None or torch.equal(has, ref[2] & live)
    if ref[1] is not None:
        want = ref[2] & live
        pairs.append((ffm[want], ref[1][want]))
        zeros.append(ffm[~want])
    ok = ok and all(torch.equal(bits(g), bits(r)) for g, r in pairs)
    ok = ok and not any(bool(z.any()) for z in zeros)
    err = max((float((g - r).abs().max()) if g.numel() else 0.0)
              for g, r in pairs)
    return ok, err


def tex_bytes(scene, t, obj, tri, alive):
    """The texture prologue's DRAM bytes on one pool: {live, taps, bytes,
    bytes_sectors}.  A live lane reads its 37 B of inputs (origin,
    direction, t, obj, tri, alive), a lane that is not 5 B (t, alive);
    every lane writes mat (40 B) and, with the normal slot, ff_mapped and
    has_nmap (13 B).  The tri_shade (256 B) and obj_tex (20 B) rows the
    live lanes touch count once: the tables stay in L2.  A tap reads four
    texels (4 B packed, 16 B f32; one 16-B row of the quad atlas), two
    levels' worth with mips; ``bytes_sectors`` charges each texel read a
    32-B sector."""
    live = tex_live(alive, t)
    n_live, lanes = int(live.sum()), int(t.shape[0])
    tid = scene.obj_tex[obj.clamp(min=0).long()][live]
    used = torch.tensor(scene.tex_slots, device=t.device)
    taps = int(((tid >= 0) & used).sum())
    out = 40 + (13 if scene.tex_slots[4] else 0)
    tables = (int(torch.unique(tri[live]).numel()) * 256
              + int(torch.unique(obj[live]).numel()) * 20)
    base = n_live * 37 + (lanes - n_live) * 5 + lanes * out + tables
    reads, size = 4, (4 if scene.tex_atlas.dim() == 2 else 16)
    if scene.tex_quad is not None:
        reads, size = 1, 16
    reads *= 2 if scene.mip_levels > 1 else 1
    return {"live": n_live, "taps": taps,
            "bytes": base + taps * reads * size,
            "bytes_sectors": base + taps * reads * max(size, 32)}


def shade_pools(dev, cfg=None):
    """K2's inputs on the main paths under ``cfg`` (default: 1024^2, 2^20
    lanes each), from fixed seeds:
    {name: (args, kwargs)} — the flagship box's bounce pool
    (``bounce_pool``, hits by the sweep) with parity and with Threefry
    draws, the textured box's NEE bounce pool with the texture
    prologue's overrides (tex+nee), the megakernel's fifth bounce
    (every pixel in block-major order, dead lanes interleaved) and the
    primary pool of a 92-triangle box (the TPU kernel's tri_sel
    class)."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    from logipathtracer_tpu_torch.render.megakernel import \
        resolve_tex_prologue
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    cfg = cfg or RenderConfig(width=1024, height=1024)
    out = {}

    def bounce(host, cfg):
        probe = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
        pool = bounce_pool(probe)
        t, obj, tri = intersect_scene_sweep(
            probe.scene, pool["origin"], pool["direction"], eps=cfg.eps,
            tile=cfg.compact_tile)
        return probe.scene, pool, t, obj, tri

    box = compile_scene(make_box_scene(spheres=10, subdiv=3))
    scene, pool, t, _, tri = bounce(box, cfg)
    for name, parity in (("bounce", True), ("bounce threefry", False)):
        out[name] = shade_args(scene, cfg, pool, t, tri, parity)
    ncfg = cfg.replace(nee=True)
    scene, pool, t, obj, tri = bounce(
        compile_scene(make_box_scene(spheres=10, subdiv=3, textured=True)),
        ncfg)
    mat, ffm, nmap = resolve_tex_prologue(scene, ncfg, pool["origin"],
                                          pool["direction"], t, obj, tri)
    out["tex+nee"] = shade_args(scene, ncfg, pool, t, tri, True, dict(
        mat=mat, ff_mapped=ffm, has_nmap=nmap, light_tris=scene.light_tris,
        light_cdf=scene.light_cdf, prev_pdf=pool["prev_pdf"],
        nee_mis=ncfg.nee_mis,
        total_light_area=float(scene.total_light_area)))
    mcfg = cfg.replace(renderer="megakernel")
    probe = ProgressiveRenderer(box, mcfg, host_seed=1, device=dev)
    args, kw = megakernel_shade_args(probe)
    out["megakernel"] = (args, kw)
    probe = ProgressiveRenderer(
        compile_scene(make_box_scene(spheres=1, subdiv=1)), cfg, host_seed=1,
        device=dev)
    o, d, seed = (x.contiguous() for x in primary_pool(probe))
    t, _, tri = intersect_scene_sweep(probe.scene, o, d, eps=cfg.eps,
                                      tile=cfg.compact_tile)
    n = o.shape[0]
    spool = dict(origin=o, direction=d, seed=seed, acc=torch.zeros_like(o),
                 mask=torch.ones_like(o),
                 alive=torch.ones(n, dtype=torch.bool, device=o.device),
                 bounce=torch.zeros(n, dtype=torch.int32, device=o.device))
    out["tri_sel"] = shade_args(probe.scene, cfg, spool, t, tri, True)
    return out


@contextlib.contextmanager
def shade_counted():
    """K2's count pass: ``shade_plain`` runs with the mask of every draw
    it makes observed (the ``get_rand`` it calls is wrapped) and its lobe
    pick and the walk's NEE hook read (``ops/bsdf.py``
    ``determine_interaction`` and ``heitz_sample`` wrapped) and its miss
    lanes noted; nothing it computes changes.  Call ``shade_plain`` as
    ``ops.kernels.shade.shade_plain`` inside.  Yields a list that
    receives one record per call, for ``shade_work``."""
    from logipathtracer_tpu_torch.ops import bsdf
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    calls = []
    get_rand, plain = sk.get_rand, sk.shade_plain
    interaction, heitz = bsdf.determine_interaction, bsdf.heitz_sample

    def counted_plain(tri_shade, origin, direction, acc, mask, alive, seed,
                      bounce, t, tri, **kw):
        out = plain(tri_shade, origin, direction, acc, mask, alive, seed,
                    bounce, t, tri, **kw)
        calls[-1]["miss"] = alive & (t >= sk.INF)
        calls[-1]["n_lights"] = (0 if kw.get("light_tris") is None
                                 else int(kw["light_tris"].shape[0]))
        return out

    def counted_get_rand(parity):
        rand = get_rand(parity)
        calls.append({"parity": bool(parity), "draws": [],
                      "eval_on": None})

        def counted(seed, mask):
            calls[-1]["draws"].append(mask.clone())
            return rand(seed, mask)
        return counted

    def counted_interaction(*a, **kw):
        lobe, seed = interaction(*a, **kw)
        calls[-1]["lobe"] = lobe.clone()
        return lobe, seed

    def counted_heitz(*a, **kw):
        if kw.get("eval_mask") is not None:
            calls[-1]["eval_on"] = kw["eval_mask"] & (kw["eval_dir"][..., 2]
                                                      > 0.0)
        return heitz(*a, **kw)

    sk.get_rand, sk.shade_plain = counted_get_rand, counted_plain
    bsdf.determine_interaction = counted_interaction
    bsdf.heitz_sample = counted_heitz
    try:
        yield calls
    finally:
        sk.get_rand, sk.shade_plain = get_rand, plain
        bsdf.determine_interaction, bsdf.heitz_sample = interaction, heitz


# K2's operations, counted from csrc/shade.cu: each +, -, *, /, sqrt,
# compare, min/max, fabs, integer add/xor/shift/multiply and each libm
# call (logf, expf, sinf, cosf, powf; sincosf as its two) is one; moves,
# selects and negations are none.  "hit": a hit lane's prologue (hit
# point, barycentrics, srgb by its powf branch, lobe weights, normal,
# frame, view), "nee_hit" what NEE adds to it (the emission's MIS
# weight), "nee_lane" a light sample without its binary search
# ("search_step" an iteration of that), "trans" the two ior quotients
# of a transmission lane; per walk order: "height" (every order),
# "vndf" (an order past the height test: the micro-normal and v.m),
# then its lobe's "tail" (diffuse, metallic, transmission by its
# reflection branch, the cheaper), "eval" the NEE hook of a diffuse
# step; "epilogue" (direction, weight, the roulette test), with NEE
# "nee_epilogue" (the pdf) and "contrib"; "rr" a drawn roulette's
# compare; "miss" the environment; a draw by its RNG.  A dead lane
# copies through: no operation.
K2_OPS = {"miss": 4, "hit": 228, "nee_hit": 19, "nee_lane": 103,
          "search_step": 4, "trans": 2, "height": 18, "vndf": 102,
          "tail": (72, 15, 33), "eval": 22, "epilogue": 26,
          "nee_epilogue": 3, "contrib": 6, "rr": 1,
          "draw": {True: 13, False: 122}}


def shade_ops(work) -> int:
    """K2's operations on one pool, from its ``shade_work`` (K2_OPS)."""
    k = K2_OPS
    lobe = work["lobe"]
    live = work["live"]
    tail = torch.tensor(k["tail"], dtype=torch.int64, device=lobe.device)
    steps = 1
    while (1 << steps) <= work["n_lights"]:
        steps += 1
    nee_mode = work["n_lights"] > 0
    per_lane = (
        k["miss"] * work["miss"]
        + live * (k["hit"] + k["epilogue"]
                  + (k["nee_hit"] if nee_mode else 0)
                  + k["trans"] * (lobe == 2).to(torch.int64))
        + work["nee"] * (k["nee_lane"] + k["search_step"] * steps
                         + k["nee_epilogue"])
        + work["eval_steps"] * k["eval"]
        + work["eval_on"] * k["contrib"]
        + work["orders"] * k["height"]
        + work["steps"] * (k["vndf"] + tail[lobe])
        + work["rr"] * k["rr"]
        + work["draws"] * k["draw"][work["parity"]])
    return int(per_lane.sum())


# Draws of one order's lobe tail: diffuse 2 (the concentric disk),
# metallic 0, transmission 1 (the Fresnel choice).
TAIL_DRAWS = (2, 0, 1)


def shade_work(rec):
    """Per lane (int64 tensors) from one ``shade_counted`` record: miss,
    live (a hit that shades: the lobe pick's mask), lobe, orders (the height
    draws its walk took), steps (the orders that passed the height test
    and sampled a micro-normal and the lobe), nee (took a light sample),
    eval_on (the NEE hook on: a light above the surface), eval_steps
    (steps with the hook on), rr (Russian roulette drew)
    and draws (every draw).  shade_plain draws the lobe, then with NEE
    three light draws, then per order six masked draws (height, two
    micro-normal, two diffuse, one Fresnel), then Russian roulette.
    Beside them: parity (the RNG) and n_lights."""
    draws = rec["draws"]
    nee = rec["eval_on"] is not None
    head = 4 if nee else 1
    walk = draws[head:-1]
    assert len(walk) % 6 == 0, "shade_plain's draws out of order"
    i64 = torch.int64
    zero = torch.zeros_like(draws[0], dtype=i64)
    orders = sum((walk[j].to(i64) for j in range(0, len(walk), 6)), zero)
    steps = sum((walk[j].to(i64) for j in range(1, len(walk), 6)), zero)
    live = draws[0].to(i64)
    lobe = rec["lobe"].to(i64) * live
    on = rec["eval_on"].to(i64) if nee else zero
    work = {"miss": rec["miss"].to(i64), "n_lights": rec["n_lights"],
            "parity": rec["parity"],
            "live": live, "lobe": lobe, "orders": orders, "steps": steps,
            "nee": draws[1].to(i64) if nee else zero,
            "eval_on": on * live * (lobe == 0).to(i64),
            "eval_steps": steps * on * live * (lobe == 0).to(i64),
            "rr": draws[-1].to(i64),
            "draws": sum((m.to(i64) for m in draws), zero)}
    tail = torch.tensor(TAIL_DRAWS, dtype=i64, device=lobe.device)[lobe]
    assert torch.equal(
        work["draws"], live + 3 * work["nee"] + orders
        + (2 + tail) * steps + work["rr"]), "draws do not add up"
    return work


def walk_efficiency(orders, lobe, warp=32):
    """(efficiency, efficiency with the lobes apart) of the Heitz walk's
    warps, one thread a lane in pool order (K2's form): the sum of the
    lanes' orders over what the warps pay.  A warp pays 32 x its longest
    walk, or, with the lobes apart, 32 x the longest walk of each lobe
    it holds (its branches run one after another)."""
    orders = np.asarray(orders, np.int64)
    lobe = np.asarray(lobe, np.int64)
    total = int(orders.sum())
    if total == 0:
        return 1.0, 1.0
    pad = -orders.shape[0] % warp
    o = np.concatenate([orders, np.zeros(pad, np.int64)]).reshape(-1, warp)
    lb = np.concatenate([lobe, np.zeros(pad, np.int64)]).reshape(-1, warp)
    cost = warp * int(o.max(1).sum())
    cost_l = warp * sum(int(np.where(lb == l, o, 0).max(1).sum())
                        for l in range(3))
    return total / cost, total / cost_l
