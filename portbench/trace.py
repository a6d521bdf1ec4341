"""Spans around the benchmark's calls into the program, and the reading
of a ``torch.profiler`` trace: the device's busy time (the union of its
kernel, memcpy and memset intervals), its idle gaps labelled by the span
the host was in, and the kernels by device time."""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

SPAN_PREFIX = "pb."
# Characters of a kernel's name kept in the breakdown.
NAME_CHARS = 100
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host time summed by span name.  While a profile is on, each span
    is also a ``record_function`` range, so the trace can say what the
    host was doing during a gap on the device."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)


class Profile:
    """One profiled stretch of whole frames between ``start`` and
    ``stop``; ``read`` exports the trace into ``workdir`` and returns its
    summary (and deletes the file)."""

    def __init__(self, spans: Spans, workdir: str):
        self.spans = spans
        self.workdir = workdir
        self.prof = None
        self._window = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._window.__enter__()
        self.spans.profiling = True

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.spans.profiling = False
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        path = os.path.join(self.workdir, f"trace_{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        finally:
            os.remove(path)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return summarize(events)


def merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, top: int = 10) -> dict:
    """From chrome-trace events (``ts``, ``dur`` in microseconds): the
    profiled window (the ``pb.window`` range), the device's busy seconds
    in it, the kernels' device seconds and counts by name, the ``top``
    device operations by time and the ``top`` longest idle gaps, each
    labelled by the ``pb.*`` span the host was in when it began."""
    win = None
    host = []
    dev = []
    cats = collections.Counter(ev.get("cat", "") for ev in events)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name = ev.get("name", "")
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name, cat))
        elif name.startswith(SPAN_PREFIX) and cat == "user_annotation":
            if name == SPAN_PREFIX + "window":
                win = (ts, ts + dur) if win is None else (
                    min(win[0], ts), max(win[1], ts + dur))
            else:
                host.append((ts, ts + dur, name[len(SPAN_PREFIX):]))
    if win is None and not host:
        raise RuntimeError("the trace has no pb.* range; event "
                           f"categories: {dict(cats)}")
    # The window: the pb.window range, widened to every span in it.
    w0 = min([s for s, _, _ in host] + ([win[0]] if win else []))
    w1 = max([e for _, e, _ in host] + ([win[1]] if win else []))
    dev = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in dev
           if e > w0 and s < w1]
    busy = merge([(s, e) for s, e, _, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name = collections.defaultdict(float)
    n_by_name = collections.Counter()
    for s, e, n, c in dev:
        key = n if c == "kernel" else c
        by_name[key] += e - s
        n_by_name[key] += 1
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host.sort()

    def label(t):
        best = None
        for s, e, n in host:
            if s > t:
                break
            if e >= t and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else "host, outside the spans"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": {k: v * 1e-6 for k, v in by_name.items()},
        "kernel_n": dict(n_by_name),
        "device_ops": [[k[:NAME_CHARS], v * 1e-6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[label(s), (e - s) * 1e-6] for s, e in gaps[:top]],
        "idle_total_s": sum(e - s for s, e in gaps) * 1e-6,
        "categories": dict(cats),
    }
