"""Shade (K2, the copy-backs, the bounce update) in device ms per wavefront
iteration, by the program's stopwatch inside the captured stages (render
cells)."""

from portbench import program_trace


def read(ctx):
    return program_trace.slot_ms(ctx, "shade")
