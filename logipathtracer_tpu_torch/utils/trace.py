"""The port's own tracing: a device stopwatch inside the wavefront
loop's stages, counters of host syncs and iterations, a ring of records
read by time window, and host spans for the profiler's timeline.

Stopwatch.  On a CUDA card a pool's ``counts`` buffer (render/
wavefront.py) holds, after stage A's three counts, one int64 slot of
nanoseconds for each of ``SLOTS``, the shadow-ray counter, the
shadow-cluster counter and the last stamp.  ``stamp`` launches csrc/trace.cu at the stage boundaries inside
``_Body.stage_a``, ``stage_b`` and ``_trace`` and, where their paths
run, inside ``render/megakernel.py`` ``shade_step``, so the launches are
captured into the stage graphs and run on every replay:

  stage_a    the sort, the ten gathers, K3 and the counts (from the top
             of stage A, where the stamp restarts: no time between
             iterations or calls is counted);
  gap        from stage A's end to stage B's start: the card waiting on
             the host's count read, plan and submit;
  regen      regen, park and the counters;
  intersect  the intersect prepass or worklist kernel, K1 or K4-K8;
  tex        the texture prologue (textured scenes only);
  shade      K2, the copy-backs and the bounce update;
  shadow     with NEE, the shadow rays' worklist and intersect in
             any-hit mode, their count and the visibility add.

A scene without textures stamps no ``tex``, and without NEE a step
stamps no ``shadow`` and no ``shade`` between K2 and the shadow rays:
its stage graphs hold the stamps of the five first slots alone.

The slots are cumulative on the card and reach the host in the
iteration's one count read, so the stopwatch adds no read; a camera
reset keeps them.  So do the shadow-ray counter (``count_shadow``, on
every device) and the shadow-cluster counter, which the same read
brings: the (tile, box) pairs the shadow rays' worklist prepass fires,
the sum of its ``wn`` (``build_cluster_worklists`` before K4 on the
streamed route, ``build_chunk_worklists`` before K1 on the resident
one), added on the device by the prepass's caller into the column
``shadow_clusters`` views; other intersect routes add nothing.  Stage B's slots of a
call's last iteration arrive with the next call's first read.  On the
CPU nothing is stamped, and a window has no slots at all.

Counters.  ``host_sync(site)`` counts each blocking wait of the host on
the card, by ``SITES``: the loop's count read (one an iteration), the
ray fold, the drain's ``pending.any()``, ``_sync()``, ``radiance()``'s
copy, a frame's copy to the host, and the copies from pageable host
memory, which wait for the stream (``upload``).  A site is counted on
every device, so a CPU run counts what the card would wait.  Nothing is
counted inside a captured stage.

Records.  At the end of each chunk, drain or single-shot call
(``loop_call``) one record, the host clock and the cumulative
iterations, syncs, slots, shadow rays and shadow clusters, goes into a
ring of ``RING`` records;
``window(t0, t1)`` gives the differences over [t0, t1].  A sync after a
call's end falls in the next record, unless ``mark()`` records the
counters where a window should start.  Counters and
ring are shared by every thread (the mesh renders on one thread per
card), under ``_build.COUNT_LOCK``.  None of this can be switched off.

Spans.  ``span(name)`` is a ``record_function("lpt.<name>")`` range
while a ``torch.profiler`` records, and a shared empty context
otherwise.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from logipathtracer_tpu_torch.ops.kernels import _build

SLOTS = ("stage_a", "gap", "regen", "intersect", "tex", "shade", "shadow")
SITES = ("count_read", "fold", "drain", "sync", "radiance", "frame",
         "upload")
# A pool's counts buffer: alive, pending and free; the slots; the
# shadow rays; the shadow clusters; the stamp.
COUNTS = 3
SHADOW = COUNTS + len(SLOTS)
CLUSTERS = SHADOW + 1
WIDTH = CLUSTERS + 2
_STAMP = WIDTH - 1
_SLOT = {s: COUNTS + i for i, s in enumerate(SLOTS)}
# The ring's length: at a few records a frame, minutes of a viewer.
RING = 1 << 16

# Columns of a record: iterations, iterations timed by the stopwatch,
# syncs by site, slot nanoseconds, shadow rays, shadow clusters.
_IT, _TIMED = 0, 1
_SITE = {s: 2 + i for i, s in enumerate(SITES)}
_NS = 2 + len(SITES)
_SHADOW = _NS + len(SLOTS)
_CLUSTERS = _SHADOW + 1
_COLUMNS = _CLUSTERS + 1


def stamp(counts: torch.Tensor, slot: str | None):
    """A stopwatch stamp on ``counts``'s stream: the time since the
    last stamp into ``slot``, or (None) the stamp alone.  Nothing on
    the CPU."""
    if counts.device.type != "cuda":
        return
    _build.launch("trace", "lpt_stamp", counts,
                  -1 if slot is None else _SLOT[slot], _STAMP,
                  _build.stream_ptr(counts.device))


def count_shadow(counts: torch.Tensor, n: torch.Tensor):
    """Add ``n`` shadow rays (an int64 scalar tensor) into ``counts``'s
    shadow-ray column, on the device: the count read brings it."""
    counts[SHADOW:SHADOW + 1].add_(n)


def shadow_clusters(counts: torch.Tensor) -> torch.Tensor:
    """The one-element view of ``counts``'s shadow-cluster column, into
    which the shadow rays' worklist prepass adds the pairs it fires."""
    return counts[CLUSTERS:CLUSTERS + 1]


class Trace:
    """Cumulative counters and the ring of records (module docstring).
    The process has one, ``TRACE``; tests make their own."""

    def __init__(self, ring: int = RING):
        self._cum = [0] * _COLUMNS
        self._times = np.zeros(ring)
        self._rows = np.zeros((ring, _COLUMNS), np.int64)
        self._n = 0

    def host_sync(self, site: str):
        with _build.COUNT_LOCK:
            self._cum[_SITE[site]] += 1

    def loop_call(self, st: dict):
        """The end of a chunk, drain or single-shot call of pool ``st``:
        its iterations, each with one count read, the stopwatch's slots
        since the pool's last call (``st["slots_seen"]``, None off the
        card, against the last read ``st["counts_read"]``), the shadow
        rays and shadow clusters since then (``st["shadow_seen"]``,
        ``st["clusters_seen"]``), a record."""
        it = st["host_it"]
        seen, read = st["slots_seen"], st.get("counts_read")
        with _build.COUNT_LOCK:
            cum = self._cum
            cum[_IT] += it
            cum[_SITE["count_read"]] += it
            if it:
                cum[_SHADOW] += read[SHADOW] - st["shadow_seen"]
                st["shadow_seen"] = read[SHADOW]
                cum[_CLUSTERS] += read[CLUSTERS] - st["clusters_seen"]
                st["clusters_seen"] = read[CLUSTERS]
            if seen is not None and it:
                cum[_TIMED] += it
                for i in range(len(SLOTS)):
                    cum[_NS + i] += read[COUNTS + i] - seen[i]
                seen[:] = read[COUNTS:COUNTS + len(SLOTS)]
            self._record()

    def mark(self) -> float:
        """Record the counters as they stand; returns the record's time,
        a window's exact start."""
        with _build.COUNT_LOCK:
            return self._record()

    def _record(self) -> float:
        k = self._n % len(self._times)
        t = self._times[k] = time.perf_counter()
        self._rows[k] = self._cum
        self._n += 1
        return t

    def _before(self, t: float):
        """The last record at or before ``t``: a copy of its row, zeros
        before the first record, None once the ring has dropped it.  The
        ring holds its records in time order from the oldest, at
        ``_n % ring`` once it has wrapped."""
        n, ring = self._n, len(self._times)
        times, rows = self._times, self._rows
        if n <= ring:
            i = int(np.searchsorted(times[:n], t, side="right"))
            return rows[i - 1].copy() if i else np.zeros(_COLUMNS,
                                                          np.int64)
        k = n % ring
        i = int(np.searchsorted(times[:k], t, side="right"))
        if i:
            return rows[i - 1].copy()
        i = int(np.searchsorted(times[k:], t, side="right"))
        return rows[k + i - 1].copy() if i else None

    def window(self, t0: float, t1: float | None = None):
        """The counts over [t0, t1] on ``time.perf_counter``'s clock (t1
        None: up to now, the counters as they stand): ``iterations``,
        ``host_syncs`` by site, ``shadow_rays``, ``shadow_clusters``
        and, where the stopwatch
        timed every iteration, ``slots_ns`` by slot; None where the ring
        no longer holds t0's record."""
        with _build.COUNT_LOCK:
            a = self._before(t0)
            if a is None:
                return None
            b = (np.array(self._cum, np.int64) if t1 is None
                 else self._before(t1))
        d = (b - a).tolist()
        out = {"iterations": d[_IT],
               "host_syncs": {s: d[i] for s, i in _SITE.items()},
               "shadow_rays": d[_SHADOW],
               "shadow_clusters": d[_CLUSTERS]}
        if d[_IT] and d[_TIMED] == d[_IT]:
            out["slots_ns"] = dict(zip(SLOTS, d[_NS:_SHADOW]))
        return out


TRACE = Trace()
host_sync = TRACE.host_sync
loop_call = TRACE.loop_call
mark = TRACE.mark
window = TRACE.window


def per_iteration(win) -> dict:
    """What the operator surfaces show of a window:
    ``host_syncs_per_iteration`` and, on the card, ``stage_ms`` (each
    slot's milliseconds an iteration); {} without iterations."""
    if not win or not win["iterations"]:
        return {}
    it = win["iterations"]
    out = {"host_syncs_per_iteration": sum(win["host_syncs"].values()) / it}
    if "slots_ns" in win:
        out["stage_ms"] = {s: v / it * 1e-6
                           for s, v in win["slots_ns"].items()}
    return out


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The host span ``lpt.<name>`` on a recording profiler's timeline;
    otherwise a flag check and nothing stored."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("lpt." + name)
    return _NO_SPAN
