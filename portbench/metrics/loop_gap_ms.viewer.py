"""The device's wait from stage A's end to stage B's start (the host's
count read, plan and submit) in ms per wavefront iteration, by the
program's stopwatch (viewer cells)."""

from portbench import program_trace


def read(ctx):
    return program_trace.slot_ms(ctx, "gap")
