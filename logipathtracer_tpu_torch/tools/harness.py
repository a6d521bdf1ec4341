"""What ``chip_smoke.py`` and ``tools/kernel_times.py`` share: the main
paths' ray pools, a runner per intersect kernel with its front end, the
K3 input tail and the timers.

The module imports no part of the package at its top: each function
imports what it needs when called, so ``tools/kernel_times.py --root``
builds the same inputs with another checkout's package.
"""

from __future__ import annotations

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
    cfg, dev, scene = renderer.config, renderer.device, renderer.scene
    pix, _ = mk.block_pixels(cfg, scene, 0, cfg.render_height, dev)
    cam = torch.from_numpy(renderer.camera_world).to(dev)
    o, d, seed = mk.camera_rays(cfg, cam, renderer.fov_y,
                                torch.tensor(seed_xy, device=dev), pix)
    o, d = o.contiguous(), d.contiguous()

    def in_key_order(o, d):
        _, perm = torch.sort(mk.ray_sort_key(scene, o, d), stable=True)
        return o[perm].contiguous(), d[perm].contiguous()

    isect = mk.pick_intersect(cfg, scene)
    n = o.shape[0]
    t, obj, tri = mk.sorted_intersect(isect, scene, o, d, cfg.eps)
    o1, d1, acc, mask, alive, seed, prev = mk.shade_step(
        scene, cfg, o, d, torch.zeros_like(o), torch.ones_like(o),
        torch.ones(n, dtype=torch.bool, device=dev), seed, 0, t, obj, tri)
    oi = torch.where(alive[:, None], o1, 1e30)
    di = torch.where(alive[:, None], d1, 1.0)
    t, obj, tri = mk.sorted_intersect(isect, scene, oi, di, cfg.eps)
    out = sk.shade(scene.tri_shade, o1, d1, acc, mask, alive, seed,
                   torch.ones(n, dtype=torch.int32, device=dev), t, tri,
                   env=cfg.env_color, rr_threshold=cfg.rr_threshold,
                   rr_bounces=cfg.rr_bounces, max_order=cfg.heitz_max_order,
                   parity=cfg.parity_rng, light_tris=scene.light_tris,
                   light_cdf=scene.light_cdf, prev_pdf=prev,
                   nee_mis=cfg.nee_mis,
                   total_light_area=float(scene.total_light_area))
    return (in_key_order(o, d), in_key_order(oi, di),
            (out[7].contiguous(), out[8].contiguous(), out[9].contiguous()),
            int(alive.sum()))


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
    its worklist, or every one, none on a K6 tile with live == 0)."""
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
        return (lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                args[:7], wn)
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
