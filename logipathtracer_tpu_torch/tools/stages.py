"""Where an iteration of the wavefront loop, or a sample of the
megakernel, spends its time.

    python -m logipathtracer_tpu_torch.tools.stages [--scene outside|box]
        [--nee] [--textured] [--res 1024] [--device cuda] [--prepass]
        [--renderer wavefront|megakernel] [--intersect MODE]
        [--no-worklist] [--set FIELD=VALUE ...]

Renders the scene (``make_outside_scene()`` or ``make_box_scene(
spheres=10, subdiv=3)``, procedural, from fixed seeds) with the default
RenderConfig at ``--res`` (``--renderer``, ``--intersect`` and
``--no-worklist``, i.e. ``compact_worklist=False``, choose the route;
``--set`` any other RenderConfig field, its value read as JSON, e.g.
``--set stream_worklist=false``, ``--set width=1920 --set height=1080``
for the default frame in place of ``--res``'s square, or ``--set
use_microfacet=false`` for the basic BSDF, whose plain-torch shading is
the stage "basic route"),
and prints one JSON line for each part:

  stages:   a warm-up step(1), then two step(2) chunks with every stage
            wrapped in device-synchronised timers (the syncs add a
            little), the wavefront loop in its eager form (stage timers
            wrap Python functions, which a replayed CUDA graph does not
            call): seconds and calls per stage over the chunks'
            iterations — the wavefront's stage A (sort, K3 flush and the
            counts), then stage B's parts (regen, ray pack, the
            intersect kernels, texture prologue, K2); an "iteration" of
            the megakernel is one sample's ``trace_rays`` (max_depth
            lockstep bounces); "rest" is the iteration total less the
            stages (ray parking, counters, the host read and the window
            plan; in the megakernel the sort, gathers and camera rays);
  busy:     (CUDA only) the device busy share: the kernel time per
            iteration of one profiled step(2) (torch.profiler, device
            rows) over the wall per iteration of three uninstrumented
            step(2) chunks of the same renderer, with the top kernels;
            for the wavefront once with the captured stages
            (render/graph.py, the renderer's form) as "busy" and once
            in the eager form as "busy_eager";
  prepass:  (--prepass, CUDA only) on the rays the main path gives the
            intersect in the first two iterations of a fresh step(2)
            (camera rays; then the first bounces, sorted first, and new
            camera rays in the freed lanes), the frustum prepass of the
            streamed path (stream_cluster.build_cluster_worklists)
            against K1's per-ray worklists (compact_intersect.
            build_chunk_worklists: the worklist kernel on the card) over
            the same per-cluster boxes:
            median ms of 10, the mean clusters fired per tile that
            holds a live ray, and K4's median ms of 10 over each
            prepass's worklists (the same hits, K1's function).

Stages are timed by wrapping module functions for the run; nothing in
the package carries timers.  On the CPU only the stage split runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from logipathtracer_tpu_torch import compile_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import shade as sk
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
from logipathtracer_tpu_torch.render import megakernel, wavefront
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                       make_outside_scene)
from logipathtracer_tpu_torch.tools.harness import event_ms


def _shadow(kw):
    return " (shadow rays)" if kw.get("has_tmax") else ""


# (module or class, attribute, stage label given the call's kwargs)
STAGES = (
    (wavefront._Body, "__call__", lambda kw: "iteration total"),
    (megakernel, "trace_rays", lambda kw: "iteration total"),
    (megakernel, "ray_sort_key", lambda kw: "sort key"),
    (wavefront._Body, "stage_a",
     lambda kw: "stage A: sort + gather + K3 flush + counts"),
    (wavefront._Body, "_regen", lambda kw: "stage B: regen"),
    (ci, "pack_rays8", lambda kw: "ray pack"),
    (ci, "build_chunk_worklists",
     lambda kw: "K1 worklist" + _shadow(kw)),
    (k4, "build_cluster_worklists",
     lambda kw: "frustum prepass" + _shadow(kw)),
    (ci, "compact_wl_intersect", lambda kw: "K1 kernel" + _shadow(kw)),
    (ci, "compact_order_intersect", lambda kw: "K7 kernel" + _shadow(kw)),
    (k6, "dense_sweep_intersect", lambda kw: "K8 kernel" + _shadow(kw)),
    (k4, "stream_cl_intersect", lambda kw: "K4 kernel" + _shadow(kw)),
    (ci, "worklist_chunk_intersect", lambda kw: "K5 kernel" + _shadow(kw)),
    (k6, "octant_chunk_intersect", lambda kw: "K6 kernel" + _shadow(kw)),
    (megakernel, "resolve_tex_prologue", lambda kw: "texture prologue"),
    (sk, "shade", lambda kw: "K2 kernel + wrapper"),
    (sk, "shade_basic", lambda kw: "basic route"),
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timers(device, seconds):
    """Wrap every STAGES function for the block; seconds[label] gathers
    [seconds, calls].  Restores the originals on exit."""
    saved = []

    def wrap(fn, label):
        def timed(*args, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(device)
            row = seconds.setdefault(label(kw), [0.0, 0])
            row[0] += time.perf_counter() - t0
            row[1] += 1
            return out
        return timed

    for owner, name, label in STAGES:
        fn = owner.__dict__[name]
        saved.append((owner, name, fn))
        setattr(owner, name, wrap(fn, label))
    try:
        yield seconds
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def make_renderer(scene: str, res: int, device, nee=False, textured=False,
                  **cfg_kw):
    g = (make_outside_scene() if scene == "outside"
         else make_box_scene(spheres=10, subdiv=3, textured=textured))
    cfg = RenderConfig(**{"width": res, "height": res, "nee": nee, **cfg_kw})
    host = compile_scene(g, cfg)
    return ProgressiveRenderer(host, cfg, host_seed=0, device=device)


@contextlib.contextmanager
def eager(renderer, on: bool = True):
    """The wavefront loop of ``renderer`` in its eager form (``on``) or
    through its captured stages for the block."""
    saved = renderer._eager
    renderer._eager = on
    try:
        yield renderer
    finally:
        renderer._eager = saved


def stage_split(renderer, chunks=(2, 2)):
    """Warm-up step(1), then the timed chunks, in the eager form:
    {"iterations": [...], "wall": s, "stages": {label: [s, calls]}} with
    a "rest" row."""
    dev = renderer.device
    seconds, iters = {}, []
    with eager(renderer):
        renderer.step(1)
        _sync(dev)
        t0 = time.perf_counter()
        with stage_timers(dev, seconds):
            for n in chunks:
                before = seconds.get("iteration total", [0.0, 0])[1]
                renderer.step(n)
                iters.append(seconds["iteration total"][1] - before)
        _sync(dev)
        wall = time.perf_counter() - t0
    total = seconds.get("iteration total", [0.0, 0])
    inner = sum(s for k, (s, _) in seconds.items() if k != "iteration total")
    seconds["rest"] = [total[0] - inner, total[1]]
    order = sorted(seconds.items(), key=lambda kv: -kv[1][0])
    return {"iterations": iters, "wall": wall,
            "stages": {k: [round(s, 6), n] for k, (s, n) in order}}


def busy_share(renderer, top=8):
    """The device busy share of ``renderer``'s step(2) chunks (CUDA
    only): the kernel time per iteration of one profiled step(2) over
    the wall per iteration of three uninstrumented ones (chunks differ
    in iterations; the megakernel counts a step as one).  Three step(2)
    first capture what the chunks replay (render/graph.py): a stage is
    captured at its first use, and some windows of the ladder come up
    only now and then."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        renderer.step(2)
    walls, iters = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.step(2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        iters.append(max(renderer.last_iterations, 1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.step(2)
        torch.cuda.synchronize()
    n = max(renderer.last_iterations, 1)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    wall_it = sum(walls) * 1e3 / sum(iters)
    return {"device_ms": device_ms, "iterations": n,
            "wall_ms": float(np.median(walls)) * 1e3, "walls_s": walls,
            "wall_iterations": iters, "device_ms_per_iteration": device_ms / n,
            "wall_ms_per_iteration": wall_it,
            "busy": device_ms / n / wall_it,
            "top": [[k[:60], ms, c] for k, ms, c in rows[:top]]}


def prepass_compare(renderer, tile: int):
    """Frustum vs per-ray prepass on the first two intersect pools of a
    fresh step(2) in the eager form (CUDA only)."""
    from logipathtracer_tpu_torch.ops.traverse import (
        _inv_rows, scene_cluster_bounds, scene_cluster_groups)
    pools = []
    frustum = k4.build_cluster_worklists

    def capture(wmin, wmax, rays8, t, **kw):
        if len(pools) < 2 and not kw.get("has_tmax"):
            pools.append(rays8.clone())
        return frustum(wmin, wmax, rays8, t, **kw)

    k4.build_cluster_worklists = capture
    try:
        with eager(renderer):
            renderer.reset()
            renderer.step(2)
    finally:
        k4.build_cluster_worklists = frustum
    scene = renderer.scene
    wmin, wmax = scene_cluster_bounds(scene)
    tables = (scene.cl_meta, _inv_rows(scene), scene.cl_aabb, scene.cl_tris)
    groups = scene_cluster_groups(scene)
    out = []
    for name, rays8 in zip(("iteration 1", "iteration 2"), pools):
        live = (rays8[0] < 1e29).reshape(-1, tile).any(1)
        row = {"pool": name, "rays": rays8.shape[1],
               "live_tiles": int(live.sum())}
        for label, build in (("frustum", frustum),
                             ("per_ray", ci.build_chunk_worklists)):
            wl, wn = build(wmin, wmax, rays8, tile)
            row[label + "_ms"] = event_ms(
                lambda: build(wmin, wmax, rays8, tile))
            row[label + "_fired_per_live_tile"] = float(
                wn[live].float().mean())
            row[label + "_k4_ms"] = event_ms(
                lambda: k4.stream_cl_intersect(rays8, wl, wn, *tables, tile,
                                               1e-4, groups=groups))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("outside", "box"), default="outside")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--textured", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prepass", action="store_true")
    ap.add_argument("--renderer", choices=("wavefront", "megakernel"),
                    default="wavefront")
    ap.add_argument("--intersect", default="auto")
    ap.add_argument("--no-worklist", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    fields = {}
    for item in args.set:
        key, _, value = item.partition("=")
        try:
            fields[key] = json.loads(value)
        except json.JSONDecodeError:
            fields[key] = value
    r = make_renderer(args.scene, args.res, dev, nee=args.nee,
                      textured=args.textured, renderer=args.renderer,
                      intersect=args.intersect,
                      compact_worklist=not args.no_worklist, **fields)
    print(json.dumps({"stages": stage_split(r)}), flush=True)
    if dev.type == "cuda":
        print(json.dumps({"busy": busy_share(r)}), flush=True)
        if args.renderer == "wavefront":
            with eager(r):
                print(json.dumps({"busy_eager": busy_share(r)}),
                      flush=True)
        if args.prepass:
            print(json.dumps({"prepass": prepass_compare(
                r, r.config.stream_tile)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
