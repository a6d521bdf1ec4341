"""What the benchmark reads of the program's own tracing
(``logipathtracer_tpu_torch/utils/trace.py``): over the measured window
alone, ``trace.window(ctx.clock.t0, ctx.clock.t1)``, the device
stopwatch's stage slots and the host-sync counters, per wavefront
iteration.  A program without that module (an earlier commit) gives
nothing, and a run off the card has no slots: the readers then return
None."""

from __future__ import annotations


def window(ctx):
    """The program's trace window over the run's measured window, or
    None."""
    try:
        from logipathtracer_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.window(ctx.clock.t0, ctx.clock.t1)


def slot_ms(ctx, slot: str):
    """The stopwatch's ``slot`` in milliseconds per iteration (card
    only)."""
    w = window(ctx)
    if not w or not w["iterations"] or "slots_ns" not in w:
        return None
    return w["slots_ns"][slot] / w["iterations"] * 1e-6


def host_syncs_per_iteration(ctx):
    """Blocking host waits of the program, every site, per iteration."""
    w = window(ctx)
    if not w or not w["iterations"]:
        return None
    return sum(w["host_syncs"].values()) / w["iterations"]
