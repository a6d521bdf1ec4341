"""Regen and park in device ms per wavefront iteration, by the program's
stopwatch inside the captured stages (viewer cells)."""

from portbench import program_trace


def read(ctx):
    return program_trace.slot_ms(ctx, "regen")
