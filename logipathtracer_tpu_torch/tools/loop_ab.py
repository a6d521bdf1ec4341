"""Device and wall time per wavefront iteration of two checkouts of this
repository, measured the same way in one call.

    python -m logipathtracer_tpu_torch.tools.loop_ab --parent DIR
        [--paths flagship,1080p,preview] [--out FILE]

``DIR`` is the root of another checkout (e.g. the parent commit,
unpacked with ``git archive``).  The script runs four child processes
in the order parent, this checkout, this checkout, parent; each imports
the package of its own checkout (so each builds and runs its own
kernels and loop) and is driven by this file, so both are measured by
the same code.  A child of this checkout measures the renderer's own
form (the CUDA graphs) and its eager form (``_eager``); the parent's
loop has one form.  Paths, on ``make_box_scene(spheres=10, subdiv=3)``
from fixed seeds:

  flagship  1024x1024, the default RenderConfig otherwise;
  1080p     RenderConfig() (1920x1080);
  preview   the 480x270 depth-4 navigation preview: a frame is a camera
            turn (``rotate(1, 0.02)``), step(1) and the drain of its
            paths (as ``tools/interactive.py`` navigates).

Each path warms up (step(1), step(2), step(2) and a camera reset; the
preview 4 frames), then times three step(2) chunks (the preview 12
frames) between device syncs, then profiles one more step(2) (12
frames) with ``torch.profiler`` and sums the kernels' device time.
Per path and form it prints one JSON line: iterations, rays, wall ms
and device ms per iteration, their ratio (busy), and the kernels by
device ms per iteration.  CUDA only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PATHS = ("flagship", "1080p", "preview")
TURN = 0.02


def _renderer(path, dev, host):
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    cfg = {"flagship": RenderConfig(width=1024, height=1024),
           "1080p": RenderConfig(),
           "preview": RenderConfig(width=480, height=270, max_depth=4)}[path]
    return ProgressiveRenderer(host, cfg, host_seed=0, device=dev)


def _chunks(r, path, n):
    """Run ``n`` units of ``path`` (a step(2) chunk, or a preview frame
    with its drain); returns the iterations and rays they took."""
    iters, rays = 0, 0.0
    for _ in range(n):
        if path == "preview":
            r.rotate(1, TURN)
            r.step(1)
            iters += r.last_iterations
            r._frame_sum()                  # the frame's drain
            rays += r.total_rays            # counted from the turn
        else:
            before = r.total_rays
            r.step(2)
            rays += r.total_rays - before
        iters += r.last_iterations
    return iters, rays


def measure(r, path):
    """Warm-up, timed units and one profiled set of units (module
    docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if path == "preview":
        _chunks(r, path, 4)
    else:
        for n in (1, 2, 2):
            r.step(n)
        r.reset()
    units = 12 if path == "preview" else 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters, rays = _chunks(r, path, units)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_iters, _ = _chunks(r, path, units)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda x: -x[1])
    device_ms = sum(x[1] for x in rows)
    wall_it = wall * 1e3 / iters
    dev_it = device_ms / p_iters
    return {"iterations": iters, "profiled_iterations": p_iters,
            "rays": rays, "wall_ms_per_iteration": wall_it,
            "device_ms_per_iteration": dev_it, "busy": dev_it / wall_it,
            "kernels_ms_per_iteration": [
                [k[:70], ms / p_iters, c] for k, ms, c in rows[:40]]}


def child(root, label, paths):
    sys.path.insert(0, root)
    import torch
    from logipathtracer_tpu_torch import compile_scene
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    dev = torch.device("cuda")
    host = compile_scene(make_box_scene(spheres=10, subdiv=3))
    for path in paths:
        forms = ((("graphs", False), ("eager", True)) if label == "change"
                 else (("eager", None),))
        for form, eager in forms:
            r = _renderer(path, dev, host)
            if eager is not None:
                r._eager = eager
            out = measure(r, path)
            print(json.dumps({"checkout": label, "path": path, "form": form,
                              **out}), flush=True)
            del r
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=False)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    if args.child:
        child(args.root, args.child, paths)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    rows = []
    for label, root in (("parent", args.parent), ("change", here),
                        ("change", here), ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", label,
             "--root", os.path.abspath(root), "--paths", ",".join(paths)],
            capture_output=True, text=True, cwd=os.path.abspath(root))
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items()
                                  if k != "kernels_ms_per_iteration"}),
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
