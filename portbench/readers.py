"""Formulas the metric readers share.  A reader returns None where it
finds nothing to read."""

from __future__ import annotations

import numpy as np

from portbench import peaks


def present_ms(ctx):
    """Host time from the ``image_u8()`` call to the frame's bytes on
    the host (the present and copy spans), per frame."""
    n = ctx.count["frames"]
    if not n:
        return None
    return (ctx.spans.seconds["present"] + ctx.spans.seconds["copy"]) \
        / n * 1e3


def iterations_per(ctx, key: str):
    n = ctx.count[key]
    return ctx.count["iterations"] / n if n else None


def iteration_ms(ctx):
    it = ctx.count["iterations"]
    return ctx.clock.elapsed / it * 1e3 if it else None


def replays_per_iteration(ctx):
    it = ctx.count["iterations"]
    return ctx.window["replays"] / it if it else None


def idle_share(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def _profiled(ctx, key):
    """A count over the profiled stretch."""
    return ctx.profile["count"][key]


def intersect_roofline(ctx):
    p = ctx.profile
    if not p:
        return None
    t, _ = peaks.layer_time(p["kernel_s"], p["kernel_n"],
                            peaks.INTERSECT_KERNELS)
    _, calls = peaks.layer_time(p["kernel_s"], p["kernel_n"],
                                peaks.INTERSECT_CALLS)
    rays = _profiled(ctx, "rays")
    if not t or not rays:
        return None
    return 100.0 * peaks.intersect_bound(rays, calls, ctx.triangles) / t


def shade_roofline(ctx):
    p = ctx.profile
    if not p:
        return None
    t, calls = peaks.layer_time(p["kernel_s"], p["kernel_n"],
                                peaks.SHADE_KERNELS)
    lanes = _profiled(ctx, "rays")
    if not t or not lanes:
        return None
    return 100.0 * peaks.shade_bound(lanes, calls, ctx.objects) / t


def p95_ms(values_s):
    if not values_s:
        return None
    return float(np.percentile(np.asarray(values_s), 95)) * 1e3
