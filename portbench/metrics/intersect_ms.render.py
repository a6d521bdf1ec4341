"""The intersect (prepass or worklist kernel, K1 or K4-K8) in device ms per
wavefront iteration, by the program's stopwatch inside the captured
stages (render cells)."""

from portbench import program_trace


def read(ctx):
    return program_trace.slot_ms(ctx, "intersect")
