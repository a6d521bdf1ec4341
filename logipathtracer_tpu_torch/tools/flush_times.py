"""K3 (the flush kernel) and ``index_add_`` on the card, their time
split into host and device time.

    python logipathtracer_tpu_torch/tools/flush_times.py [--root DIR]
        [--label NAME] [--runs 50]

Times ``flush.flush_sorted`` of the ``logipathtracer_tpu_torch`` package
under ``--root`` (default: the checkout that holds this script), so that
an earlier version of K3 and its wrapper, e.g. a ``git archive`` of an
earlier commit unpacked beside this one, is measured by the same code
in the same call.  Run it as a file, not with ``-m``: the package must
be imported from ``--root``.

The inputs are those of ``chip_smoke.py``'s K3 check: a sorted pool tail
of 2^20 rows, the last 2^18 retired with ascending pixel ids of a
1024^2 accumulator (``make_tail``).  K3 must equal its plain version and
repeat bit for bit.  For K3 and for ``index_add_`` of the retired rows
into the same accumulator it prints, in one JSON line with the card's
name and power limit:

  event_ms:  the median of 10 single calls between two CUDA events on an
             idle device (what ``chip_smoke.py``'s kernel rows hold): the
             host's time to issue the call, then the device's;
  device_ms: the kernel rows of ``torch.profiler`` over ``--runs`` calls,
             divided by the calls: the device's own time;
  stream_ms: ``--runs`` calls back to back between two events, divided
             by the calls;
  host_us:   the host's time to issue one of those calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_tail(npix, rows, retired, dev, seed=0):
    """A sorted pool tail: -1 prefix, then `retired` ascending pixel ids
    (with repeats, as several samples of one pixel retire together)."""
    rng = np.random.default_rng(seed)
    pix = np.sort(rng.integers(0, npix, retired)).astype(np.int32)
    pix = np.concatenate([np.full(rows - retired, -1, np.int32), pix])
    acc = rng.random((rows, 3), dtype=np.float32)
    return (torch.from_numpy(pix).to(dev), torch.from_numpy(acc).to(dev))


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


def event_ms(fn, runs=10):
    """The median of ``runs`` single calls, each between two events."""
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


def measure(flush, dev, runs, npix=1 << 20, rows=1 << 20, retired=1 << 18):
    """{"k3": times, "index_add_": times} on ``make_tail``'s inputs, each
    times a dict of event_ms, device_ms, stream_ms and host_us; K3 checked
    against its plain version and a repeat first."""
    pix, acc = make_tail(npix, rows, retired, dev)
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
        ev = event_ms(fn)
        d, s, h = device_ms(fn, runs)
        out[name] = {"event_ms": ev, "device_ms": d, "stream_ms": s,
                     "host_us": h}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_ROOT,
                    help="checkout whose logipathtracer_tpu_torch to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flush_times: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from logipathtracer_tpu_torch.ops.kernels import flush
    assert os.path.abspath(flush.__file__).startswith(root + os.sep), \
        f"imported {flush.__file__}, not the package under {root}"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    times = measure(flush, torch.device("cuda"), args.runs)
    print(json.dumps({"label": args.label or root, "card": card,
                      "runs": args.runs, **times}), flush=True)


if __name__ == "__main__":
    main()
