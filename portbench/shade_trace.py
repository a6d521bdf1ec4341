"""What the benchmark reads of the program's trace inside its shade
step (render/megakernel.py ``shade_step``): the stopwatch's ``tex`` and
``shadow`` slots and the shadow-ray counter, per wavefront iteration,
over the measured window (``program_trace.window``).  A program that
has no such slot or counter (an earlier commit) gives None, as does a
run off the card for the slots; nothing here raises for their lack."""

from __future__ import annotations

from portbench import program_trace


def slot_ms(ctx, slot: str):
    """The stopwatch's ``slot`` in milliseconds per iteration, or None
    where the window has no such slot."""
    w = program_trace.window(ctx)
    if not w or not w.get("iterations"):
        return None
    ns = (w.get("slots_ns") or {}).get(slot)
    return None if ns is None else ns / w["iterations"] * 1e-6


def shadow_rays_per_iteration(ctx):
    """Shadow rays cast per iteration, or None where the window has no
    shadow-ray counter."""
    w = program_trace.window(ctx)
    if not w or not w.get("iterations") or "shadow_rays" not in w:
        return None
    return w["shadow_rays"] / w["iterations"]
