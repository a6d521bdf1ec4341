"""Kernel times on the card for this checkout's package or another's:
K3 beside ``index_add_`` (``flush``), and the compacted-visit intersect
kernels K1, K4 and K5 with the outside main path's rate (``isect``).

    python logipathtracer_tpu_torch/tools/kernel_times.py flush
        [--root DIR] [--label NAME] [--runs 50]
    python logipathtracer_tpu_torch/tools/kernel_times.py isect
        [--root DIR] [--label NAME] [--runs 10] [--main-runs N]

Times the ``logipathtracer_tpu_torch`` package under ``--root`` (default:
the checkout that holds this script), so that an earlier commit, e.g. a
``git archive`` unpacked into the git-ignored ``.checkout/``, is measured
by the same code in the same call: the inputs and timers are this
checkout's ``tools/harness.py``, loaded by its path.  Run it as a file,
not with ``-m``: the package must be imported from ``--root``.  Prints
one JSON line with the card's name and power limit.

``flush``: the inputs of ``chip_smoke.py``'s K3 check, a sorted pool
tail of 2^20 rows, the last 2^18 retired with ascending pixel ids of a
1024^2 accumulator (``harness.make_tail``).  K3 must equal its plain
version and repeat bit for bit.  For K3 and for ``index_add_`` of the
retired rows into the same accumulator:

  event_ms:  the median of 10 single calls between two CUDA events on an
             idle device (what ``chip_smoke.py``'s kernel rows hold): the
             host's time to issue the call, then the device's;
  device_ms: the kernel rows of ``torch.profiler`` over ``--runs`` calls,
             divided by the calls: the device's own time;
  stream_ms: ``--runs`` calls back to back between two events, divided
             by the calls;
  host_us:   the host's time to issue one of those calls.

``isect``: the pools are ``chip_smoke.py``'s, 2^20 rays each, from fixed
seeds (``harness.pools``): on ``make_outside_scene()`` under the default
RenderConfig at 1024^2, which routes it to K4, the primary pool, the
bounce pool after one step and that bounce's NEE shadow pool (t_max +
any-hit); on the flagship box ``make_box_scene(spheres=10, subdiv=3)``
(K1) the same three.  Each time is the median of ``--runs`` single calls
between two CUDA events.

  k4, k5, k1: ms per pool (K5 on the outside primary and bounce pools),
              with the mean worklist length wn of K4's and K5's pools;
  main:       with ``--main-runs N``: the outside main path N times, each
              a fresh renderer (host seed 0): a warm-up step(1), then
              step(2) twice, timed — samples/s, Mrays/s, mean radiance
              and ray count.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))


def load_harness():
    """This checkout's tools/harness.py, loaded by its path, so that it
    does not import the package before ``--root`` is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "_lpt_harness", os.path.join(_HERE, "harness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flush_times(h, dev, runs, npix=1 << 20, rows=1 << 20, retired=1 << 18):
    """{"k3": times, "index_add_": times} on ``make_tail``'s inputs, each
    times a dict of event_ms, device_ms, stream_ms and host_us; K3 checked
    against its plain version and a repeat first."""
    from logipathtracer_tpu_torch.ops.kernels import flush
    pix, acc = h.make_tail(npix, rows, retired, dev)
    base = torch.rand((npix, 3), generator=torch.Generator().manual_seed(1))
    base = base.to(dev)
    k1 = flush.flush_sorted(base.clone(), pix, acc)
    k2 = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    assert torch.equal(k1, k2), "K3: repeat run not bit-identical"
    assert torch.equal(k1, p), "K3: differs from its plain version"
    work = base.clone()
    tail = slice(rows - retired, rows)
    pix_r, acc_r = pix[tail].contiguous(), acc[tail].contiguous()
    out = {}
    for name, fn in (("k3", lambda: flush.flush_sorted(work, pix, acc)),
                     ("index_add_", lambda: work.index_add_(0, pix_r,
                                                            acc_r))):
        ev = h.event_ms(fn)
        d, s, us = h.device_ms(fn, runs)
        out[name] = {"event_ms": ev, "device_ms": d, "stream_ms": s,
                     "host_us": us}
    return out


def isect_times(h, dev, runs, main_runs):
    """{"k4", "k5", "k1": ms per pool, "wn": mean worklist per K4 / K5
    pool, "main": the outside main path's runs}."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.ops.kernels import _build
    from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                           make_outside_scene)
    _build.load_all(("compact_intersect", "shade", "flush", "stream_cluster",
                     "stream_chunk"))
    out = {"k4": {}, "k5": {}, "k1": {}, "wn": {}}
    cfg = RenderConfig(width=1024, height=1024)
    outside = compile_scene(make_outside_scene())
    scene = outside.to(dev)
    tile = cfg.stream_tile
    for name, (rays8, kw) in h.pools(outside, cfg, dev, tile).items():
        for kind in ("K4", "K5") if name != "shadow" else ("K4",):
            kernel, _, _, wn = h.runner(kind, scene, rays8, tile, **kw)
            out[kind.lower()][name] = h.event_ms(kernel, runs)
            out["wn"][f"{kind} {name}"] = float(wn.float().mean())
    box = compile_scene(make_box_scene(spheres=10, subdiv=3))
    btile = cfg.compact_tile
    bscene = box.to(dev)
    for name, (rays8, kw) in h.pools(box, cfg, dev, btile).items():
        kernel = h.runner("K1", bscene, rays8, btile, **kw)[0]
        out["k1"][name] = h.event_ms(kernel, runs)
    main = []
    for _ in range(main_runs):
        r = ProgressiveRenderer(outside, cfg, host_seed=0, device=dev)
        sps, mrays, iters, rad = h.timed_steps(r)
        main.append({"samples_per_s": sps, "mrays_per_s": mrays,
                     "iterations": iters, "mean_radiance": float(rad.mean()),
                     "rays": int(r.total_rays)})
        del r
    out["main"] = main
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", choices=("flush", "isect"))
    ap.add_argument("--root", default=_ROOT,
                    help="checkout whose logipathtracer_tpu_torch to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=None,
                    help="calls per time (flush: 50, isect: 10)")
    ap.add_argument("--main-runs", type=int, default=0,
                    help="isect: outside main path runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    root = os.path.abspath(args.root)
    h = load_harness()
    sys.path.insert(0, root)
    import logipathtracer_tpu_torch as pkg
    assert os.path.abspath(pkg.__file__).startswith(root + os.sep), \
        f"imported {pkg.__file__}, not the package under {root}"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if args.kernels == "flush":
        runs = args.runs or 50
        res = flush_times(h, dev, runs)
    else:
        runs = args.runs or 10
        res = isect_times(h, dev, runs, args.main_runs)
    print(json.dumps({"label": args.label or root, "card": card,
                      "kernels": args.kernels, "runs": runs, **res,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
