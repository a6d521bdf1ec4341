"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, the result line.

Everything that belongs to a configuration, a traffic mix or a metric
is found by the name ``BENCHMARK.json`` gives it: ``configs/<name>.json``
(the scene generator and its arguments, the render settings, the
preview), ``traffic/<mix>.json`` (the driver, ``drivers/<driver>.py``,
and its parameters), ``metrics/<metric>.py`` (a reader ``read(ctx)``
that returns the metric or None where it finds nothing to read) and
``limits/<cell>.json`` (the limit of each number the check compares).

The program under test is the port, ``logipathtracer_tpu_torch``: the
scene goes to it as a binary glTF file, through ``load_gltf`` and
``compile_scene`` as the command line loads it, and the drivers make the
calls its entry points make.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "logipathtracer_tpu")
# Seconds of whole frames the traced run profiles after its window: the
# same traffic, continued.
PROFILE_S = 2.0


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def since_process_start() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """The window on the host's clock: its start, each present, its end
    (the last present)."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.intervals = []
        self._prev = None

    def start(self) -> float:
        self.t0 = self._prev = time.perf_counter()
        return self.t0

    def present(self):
        now = time.perf_counter()
        self.intervals.append(now - self._prev)
        self._prev = now

    def stop(self):
        self.t1 = self._prev

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


class Cell:
    """A cell's settings and the state its driver shares: the renderers,
    host spans, counts and the clock."""

    def __init__(self, workload: dict, seed: int, seconds: float,
                 trace: bool, device=None, overrides: dict | None = None,
                 root: str = HERE):
        import torch
        self.name = workload["name"]
        ov = overrides or {}
        self.config = load_json(root, "configs",
                                workload["config"] + ".json")
        self.traffic = load_json(root, "traffic",
                                 workload["traffic"] + ".json")
        self.config["scene"].update(ov.get("scene", {}))
        self.config["scene"]["args"].update(ov.get("scene_args", {}))
        self.config["render"].update(ov.get("render", {}))
        self.config.setdefault("preview", {}).update(ov.get("preview", {}))
        self.traffic.update(ov.get("traffic", {}))
        self.limits = load_json(root, "limits", self.name + ".json")
        self.root = root
        self.host_seed = abs(int(seed))
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device or "cuda")
        from portbench.trace import Spans
        self.spans = Spans()
        self.count = {"frames": 0, "samples": 0, "rays": 0.0,
                      "iterations": 0, "attempted": 0}
        self.clock = Clock()
        self.renderers = {}
        self.setup = {}
        self.workdir = tempfile.mkdtemp(prefix="portbench_")
        self.scene_desc = None
        self.gltf = None
        self.render_used = None
        self.fov = None
        self.camera = None

    # -- inputs -----------------------------------------------------------

    def rng(self, tag: str) -> np.random.Generator:
        """A generator of the benchmark's own draws, from the seed."""
        tags = {"pixels": 1, "renders": 2}
        return np.random.default_rng([self.host_seed, tags[tag]])

    @contextlib.contextmanager
    def timed(self, what: str):
        t0 = time.perf_counter()
        yield
        self.setup[what] = self.setup.get(what, 0.0) + (
            time.perf_counter() - t0)

    def load_scene(self):
        """The configuration's scene, written as a .glb under the run's
        temporary directory and loaded by the port's loader."""
        from logipathtracer_tpu_torch.scene.gltf import load_gltf
        from portbench.scenes.glb import write_glb
        sc = self.config["scene"]
        with self.timed("scene_generate_s"):
            gen = load_module(os.path.join(self.root, "scenes",
                                           sc["generator"] + ".py"),
                              "portbench_scene_" + sc["generator"])
            self.scene_desc = gen.make(**sc["args"])
            path = write_glb(self.scene_desc,
                             os.path.join(self.workdir, "scene.glb"))
        with self.timed("scene_load_s"):
            self.gltf = load_gltf(path)
        cam = self.scene_desc.cameras[0]
        self.camera = np.asarray(cam.world_matrix, np.float32)
        self.fov = float(cam.yfov)

    def renderer(self, kind: str):
        """The cell's renderer: "full" at the configuration's settings, or
        "preview" as ``web`` builds it (cli/main.py ``_build_web``)."""
        from logipathtracer_tpu_torch.config import RenderConfig
        from logipathtracer_tpu_torch.render.progressive import \
            ProgressiveRenderer
        from logipathtracer_tpu_torch.scene.compile import compile_scene
        render = dict(self.config["render"])
        if kind == "preview":
            pv = self.config["preview"]
            render["width"] = max(64, render["width"] // pv["scale"])
            render["height"] = max(64, render["height"] // pv["scale"])
            if pv.get("depth") and pv["depth"] < render["max_depth"]:
                render["max_depth"] = pv["depth"]
        self.render_used = render
        fields = RenderConfig.__dataclass_fields__
        cfg = RenderConfig(**{k: v for k, v in render.items()
                              if k in fields})
        with self.timed("scene_compile_s"):
            scene = compile_scene(self.gltf, cfg)
        with self.timed("renderer_s"):
            r = ProgressiveRenderer(scene, cfg, camera=scene.cameras[0],
                                    host_seed=self.host_seed,
                                    device=self.device)
        self.renderers[kind] = r
        return r

    # -- counters ----------------------------------------------------------

    def graph_stats(self) -> dict:
        out = {"replays": 0, "captures": 0, "capture_seconds": 0.0}
        if self.device.type != "cuda":
            return out
        from logipathtracer_tpu_torch.render.graph import graph_cache
        for r in self.renderers.values():
            g = graph_cache(r.scene)
            out["replays"] += g.replays
            out["captures"] += g.captures
            out["capture_seconds"] += g.capture_seconds
        return out

    def close(self):
        shutil.rmtree(self.workdir, ignore_errors=True)


def apply_fault(r, fault: str):
    """Break the timed path under one renderer (for the harness's own
    tests): "frozen", a step that leaves the state unchanged; "half", a
    drain that folds only the even rows of its samples in; "altered",
    every presented frame's red channel altered where it is made."""
    import torch
    if fault == "frozen":
        r.step = r.step_nosync = lambda samples=1: r
    elif fault == "half":
        drain = r._drain_pool

        def half():
            before = r.accum.clone()
            drain()
            r.accum[1::2] = before[1::2]
        r._drain_pool = half
    elif fault == "altered":
        image_u8 = r.image_u8

        def altered():
            out = image_u8()
            out[..., 0] ^= torch.tensor(16, dtype=torch.uint8)
            return out
        r.image_u8 = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")


def profiled_extension(cell: Cell, driver) -> dict:
    """After the window: ``PROFILE_S`` more seconds of the same traffic
    under ``torch.profiler``, with their own clock and counts, so that
    the profiler's cost stays out of the window.  Returns the trace's
    summary with the extension's counts."""
    from portbench.trace import Profile, Spans
    saved = cell.count, cell.clock, cell.spans
    cell.count = {k: 0 for k in saved[0]}
    cell.clock = Clock()
    cell.spans = Spans()
    prof = Profile(cell.spans, cell.workdir)
    prof.start()
    driver.window(PROFILE_S)
    prof.stop()
    summary = prof.read()
    summary["count"] = cell.count
    saved[0]["attempted"] += cell.count["attempted"]
    cell.count, cell.clock, cell.spans = saved
    return summary


def reported(bench: dict, cell: str, trace: bool) -> list:
    """The metrics (entries of BENCHMARK.json) this cell reports: its
    end-to-end ones without the trace, its per-layer ones with it."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: str = HERE, device=None, overrides=None, fault=None,
        control=False) -> dict:
    """One run; returns the result line's object (its ``checks`` last).
    ``device``, ``overrides`` and ``fault`` are for the harness's own
    tests; ``control`` puts a bfloat16 reference in the program's place
    in the check.  ``overrides`` updates the configuration's ``scene``
    (its generator and arguments), ``scene_args``, ``render`` and
    ``preview`` and the traffic's parameters (``traffic``)."""
    t_proc = time.perf_counter() - since_process_start()
    bench = load_json(os.path.dirname(root), "BENCHMARK.json")
    t0 = time.perf_counter()
    import torch
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the "
                             "card")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise SystemExit(f"{workload} needs {wl['chips']} devices, "
                             f"found {torch.cuda.device_count()}")
        torch.cuda.init()
        torch.empty(1, device="cuda")
    import logipathtracer_tpu_torch  # noqa: F401  (the program)
    cell = Cell(wl, seed, seconds, trace, device=device,
                overrides=overrides, root=root)
    cell.setup["torch_and_device_s"] = time.perf_counter() - t0
    try:
        return _run(cell, bench, t_proc, fault, control)
    finally:
        cell.close()


def _run(cell: Cell, bench: dict, t_proc: float, fault, control) -> dict:
    import torch
    cell.load_scene()
    drv_mod = load_module(os.path.join(cell.root, "drivers",
                                       cell.traffic["driver"] + ".py"),
                          "portbench_driver_" + cell.traffic["driver"])
    driver = drv_mod.DRIVER(cell, cell.traffic)
    driver.build()
    if fault:
        for r in cell.renderers.values():
            apply_fault(r, fault)
    cuda = cell.device.type == "cuda"
    t_w = time.perf_counter()
    driver.warm_up()
    if cuda:
        torch.cuda.synchronize(cell.device)
    cell.setup["warm_up_s"] = time.perf_counter() - t_w
    from logipathtracer_tpu_torch.ops.kernels import _build
    cell.setup["kernel_build_s"] = sum(_build.BUILD_SECONDS.values())
    start = cell.graph_stats()
    cell.setup["graph_capture_s"] = start["capture_seconds"]

    driver.window(cell.seconds)
    if cuda:
        torch.cuda.synchronize(cell.device)
    setup_s = cell.clock.t0 - t_proc
    end = cell.graph_stats()
    window = {k: end[k] - start[k] for k in ("replays", "captures")}
    peak = (torch.cuda.max_memory_allocated(cell.device) if cuda else 0)
    profile = None
    if cell.trace and cuda:
        profile = profiled_extension(cell, driver)
    driver.finish()

    ctx = types.SimpleNamespace(
        cell=cell.name, count=cell.count, window=window, clock=cell.clock,
        spans=cell.spans, setup_s=setup_s, profile=profile,
        triangles=cell.scene_desc.triangle_count,
        objects=sum(len(n.primitives) for n in cell.scene_desc.mesh_nodes))
    metrics = {}
    for m in reported(bench, cell.name, cell.trace):
        reader = load_module(os.path.join(cell.root, "metrics",
                                          m["name"] + ".py"),
                             "portbench_metric_" + m["name"])
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else cell.device.type,
           "kind": (torch.cuda.get_device_name(cell.device) if cuda
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": int(cell.count["attempted"]),
              "failed": 0, "metrics": metrics, "device": dev}
    if cell.trace and profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    info = {"setup": cell.setup, "setup_s": setup_s,
            "window_s": cell.clock.elapsed, "counts": cell.count,
            "window_graphs": window}
    print("portbench: " + json.dumps(info), file=sys.stderr)

    # The program's state goes before the reference runs.
    scene_desc, render, accs = cell.scene_desc, cell.render_used, driver.accs
    driver.r = None
    cell.renderers.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from portbench import check
    out = check.run_check(scene_desc, render, accs, cell.device,
                          control=control)
    print("portbench: check " + json.dumps(out), file=sys.stderr)
    checks = {k: {"value": out[k], "limit": float(cell.limits[k])}
              for k in ("radiance_bad", "frame_bad")}
    result["correct"] = all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                             "benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except SystemExit as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except Exception:  # the run failed: no result line
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
