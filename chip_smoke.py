"""Chip smoke test of the PyTorch + CUDA port (logipathtracer_tpu_torch).

    python3 chip_smoke.py [--scene SCENE.gltf]

Needs one CUDA card; fails (exit 1, no result line) without one.  From
the root of a checkout it:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the three CUDA kernels from logipathtracer_tpu_torch/csrc;
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (K1 on the 2^20-ray primary pool and on a
     bounce pool of the render, K2 on that 2^20-lane pool, K3 on a
     2^18-row sorted retired tail into a 1024^2 accumulator), with
     median times of both;
  4. drives the flagship main path — ProgressiveRenderer at 1024x1024,
     max_depth 10, Heitz, parity RNG, 2^20-lane wavefront pool — and
     checks that it ran through all three kernels and never through a
     plain version;
  5. renders 64x64 at 2+2 spp on the card and on the CPU with the same
     seed and requires >= 99.5% of pixels to agree (rtol 1e-4,
     atol 1e-6).

The scene is the glTF given with --scene, else the procedural box
``make_box_scene(spheres=10, subdiv=3)`` (12,812 triangles, 86 clusters,
the resident class of the reference's cornell box), built from a fixed
seed; the host seeds are fixed too.

Prints one JSON line of kernel results, then the card line, then as its
last line {"ok": true, "device": {...}}.  Any failed check raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

# Tolerances.  K1 and K2 use the rules kept beside their kernels
# (compact_intersect.hits_agree: t within rtol 2e-6 / atol 1e-6, tri/obj
# differing only on t ties; shade.shade_agreement: at most 0.5% of lanes
# with another seed or alive flag, floats close on the rest).
K3_RTOL, K3_ATOL = 1e-6, 1e-6           # f32 reassociation
IMG_RTOL, IMG_ATOL, IMG_FRAC = 1e-4, 1e-6, 0.995  # test_wavefront.py:36-37


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def load_scene(path):
    from logipathtracer_tpu_torch import compile_scene, load_gltf
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    g = load_gltf(path) if path else make_box_scene(spheres=10, subdiv=3)
    return compile_scene(g)


def _median_ms(fn, runs: int) -> float:
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


def _counters():
    from logipathtracer_tpu_torch.ops.kernels import (compact_intersect,
                                                      flush, shade)
    return {"compact_intersect": compact_intersect, "shade": shade,
            "flush": flush}


def reset_counts():
    for m in _counters().values():
        m.launches = 0
        m.plain_calls = 0


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
    """A mid-render pool: the flagship's state after one step, alive
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
             "bounce")}
    dead = ~pool["alive"]
    pool["origin"][dead] = 1e30
    pool["direction"][dead] = 1.0
    return pool


def check_k1(scene, origin, direction, tile, eps, runs=(10, 3)):
    """K1 against its plain version on one pool; returns
    (max_abs_err, kernel_ms, plain_ms, hit fraction)."""
    from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
    from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
    rays8, _ = ci.pack_rays8(origin, direction, tile)
    wmin, wmax = scene_cluster_bounds(scene)
    wl, wn = ci.build_chunk_worklists(wmin, wmax, rays8, tile)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb,
            scene.cl_tris, tile, eps)
    got = ci.compact_wl_intersect(*args)
    ref = ci.compact_wl_intersect_plain(*args)
    torch.cuda.synchronize()
    err = ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])
    hit_frac = float((ref[0] < ci.BIG).float().mean())
    k_ms = _median_ms(lambda: ci.compact_wl_intersect(*args), runs[0])
    p_ms = _median_ms(lambda: ci.compact_wl_intersect_plain(*args), runs[1])
    return err, k_ms, p_ms, hit_frac


def check_k2(scene, cfg, pool, t, tri, parity, runs=(10, 3)):
    from logipathtracer_tpu_torch.ops.kernels import shade as sk
    args = (scene.tri_shade, pool["origin"], pool["direction"], pool["acc"],
            pool["mask"], pool["alive"], pool["seed"], pool["bounce"], t,
            tri)
    kw = dict(env=cfg.env_color, rr_threshold=cfg.rr_threshold,
              rr_bounces=cfg.rr_bounces, max_order=cfg.heitz_max_order,
              parity=parity)
    got = sk.shade(*args, **kw)
    ref = sk.shade_plain(*args, **kw)
    torch.cuda.synchronize()
    diverged, err = sk.shade_agreement([x.cpu() for x in ref],
                                       [x.cpu() for x in got])
    k_ms = _median_ms(lambda: sk.shade(*args, **kw), runs[0])
    p_ms = _median_ms(lambda: sk.shade_plain(*args, **kw), runs[1])
    return diverged, err, k_ms, p_ms


def make_tail(npix, rows, retired, dev, seed=0):
    """A sorted pool tail: -1 prefix, then `retired` ascending pixel ids
    (with repeats, as several samples of one pixel retire together)."""
    rng = np.random.default_rng(seed)
    pix = np.sort(rng.integers(0, npix, retired)).astype(np.int32)
    pix = np.concatenate([np.full(rows - retired, -1, np.int32), pix])
    acc = rng.random((rows, 3), dtype=np.float32)
    return (torch.from_numpy(pix).to(dev), torch.from_numpy(acc).to(dev))


def check_k3(dev, npix=1 << 20, rows=1 << 20, retired=1 << 18, runs=(10, 3)):
    from logipathtracer_tpu_torch.ops.kernels import flush
    pix, acc = make_tail(npix, rows, retired, dev)
    base = torch.rand((npix, 3), generator=torch.Generator().manual_seed(1))
    base = base.to(dev)
    k1 = flush.flush_sorted(base.clone(), pix, acc)
    k2 = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2), "K3: repeat run not bit-identical"
    k1, p = k1.cpu().numpy(), p.cpu().numpy()
    np.testing.assert_allclose(k1, p, rtol=K3_RTOL, atol=K3_ATOL)
    err = float(np.abs(k1 - p).max())
    work = base.clone()
    k_ms = _median_ms(lambda: flush.flush_sorted(work, pix, acc), runs[0])
    p_ms = _median_ms(lambda: flush.flush_sorted_plain(work, pix, acc),
                      runs[1])
    return err, k_ms, p_ms


def render_radiance(scene, cfg, dev, host_seed, chunks):
    from logipathtracer_tpu_torch import ProgressiveRenderer
    r = ProgressiveRenderer(scene, cfg, host_seed=host_seed, device=dev)
    for n in chunks:
        r.step(n)
    return r.radiance(), r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=None,
                    help="glTF scene (default: procedural box)")
    args = ap.parse_args(argv)

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 1
    # The package comes first: a copy of this script without the rest
    # of the repository fails here, before printing anything.
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    for name in ("compact_intersect", "shade", "flush"):
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"{json.dumps(_build.BUILD_SECONDS)}", flush=True)

    t0 = time.perf_counter()
    host_scene = load_scene(args.scene)
    cfg = RenderConfig(width=1024, height=1024)
    print(f"scene: {host_scene.num_triangles} triangles, "
          f"{host_scene.num_objects} objects, "
          f"{host_scene.cl_tris.shape[0]} clusters "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 3. kernels vs plain at main-path shapes --------------------------
    probe = ProgressiveRenderer(host_scene, cfg, host_seed=1, device=dev)
    scene = probe.scene
    tile = cfg.compact_tile
    o, d, _ = primary_pool(probe)
    k1p = check_k1(scene, o, d, tile, cfg.eps)
    print(f"K1 primary pool {o.shape[0]} rays: max|dt| {k1p[0]:.3g}, "
          f"hit {k1p[3]:.3f}, kernel {k1p[1]:.3f} ms, plain {k1p[2]:.1f} ms",
          flush=True)
    pool = bounce_pool(probe)
    k1b = check_k1(scene, pool["origin"], pool["direction"], tile, cfg.eps)
    print(f"K1 bounce pool ({int(pool['alive'].sum())} alive): max|dt| "
          f"{k1b[0]:.3g}, kernel {k1b[1]:.3f} ms, plain {k1b[2]:.1f} ms",
          flush=True)
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    t, _, tri = intersect_scene_sweep(scene, pool["origin"],
                                      pool["direction"], eps=cfg.eps,
                                      tile=tile)
    k2 = check_k2(scene, cfg, pool, t, tri, parity=True)
    print(f"K2 parity {pool['alive'].shape[0]} lanes: diverged "
          f"{k2[0]:.5f}, max|d| {k2[1]:.3g}, kernel {k2[2]:.3f} ms, "
          f"plain {k2[3]:.1f} ms", flush=True)
    k2t = check_k2(scene, cfg, pool, t, tri, parity=False, runs=(3, 1))
    print(f"K2 threefry: diverged {k2t[0]:.5f}, max|d| {k2t[1]:.3g}, "
          f"kernel {k2t[2]:.3f} ms", flush=True)
    k3 = check_k3(dev)
    print(f"K3 2^18 retired of 2^20 rows into 1024^2: max|d| {k3[0]:.3g}, "
          f"bit-identical repeat, kernel {k3[1]:.3f} ms, plain "
          f"{k3[2]:.3f} ms", flush=True)
    del probe, pool

    # ---- 4. the main path ----------------------------------------------
    renderer = ProgressiveRenderer(host_scene, cfg, host_seed=0, device=dev)
    reset_counts()
    renderer.step(1)                        # warm-up
    torch.cuda.synchronize()
    rays0 = renderer.total_rays
    t0 = time.perf_counter()
    timed = (2, 2)
    iters = []
    for n in timed:
        renderer.step(n)
        iters.append(renderer.last_iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = renderer.total_rays - rays0
    rad = renderer.radiance()
    counts = {k: (m.launches, m.plain_calls)
              for k, m in _counters().items()}
    assert rad.shape == (1024, 1024, 3) and np.isfinite(rad).all()
    mean = float(rad.mean())
    assert 1e-3 < mean < 10.0, f"implausible mean radiance {mean}"
    for k, (launched, plain) in counts.items():
        assert launched > 0, f"main path never launched kernel {k}"
        assert plain == 0, f"main path ran the plain version of {k}"
    spp = sum(timed)
    print(f"main path 1024x1024 spp {spp}: {spp / wall:.3f} samples/s, "
          f"{rays / wall / 1e6:.2f} Mrays/s, iterations per chunk {iters}, "
          f"mean radiance {mean:.6f} [{card}]", flush=True)
    print(f"launches: {json.dumps(counts)}", flush=True)

    # ---- 5. card vs CPU image ------------------------------------------
    small = RenderConfig(width=64, height=64, pool_size=4096)
    img_gpu, _ = render_radiance(host_scene, small, dev, 7, (2, 2))
    img_cpu, _ = render_radiance(host_scene, small, "cpu", 7, (2, 2))
    close = np.isclose(img_gpu, img_cpu, rtol=IMG_RTOL,
                       atol=IMG_ATOL).all(-1)
    print(f"card vs CPU 64x64 2+2 spp: {close.mean():.5f} of pixels close",
          flush=True)
    assert close.mean() >= IMG_FRAC, "card and CPU renders disagree"

    from logipathtracer_tpu_torch.ops.kernels import (compact_intersect,
                                                      flush, shade)
    rows = [
        ("compact_intersect", compact_intersect, k1p[0], k1p[1], k1p[2]),
        ("shade", shade, k2[1], k2[2], k2[3]),
        ("flush", flush, k3[0], k3[1], k3[2]),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": m.SOURCE,
         "replaces": m.REPLACES, "launches": counts[n][0],
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
        for n, m, err, k_ms, p_ms in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
