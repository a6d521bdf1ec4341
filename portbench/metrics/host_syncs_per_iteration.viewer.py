"""The program's blocking host waits on the device (its count reads,
ray folds, drain tests, syncs and copies) per wavefront iteration, by
its own counters (viewer cells)."""

from portbench import program_trace


def read(ctx):
    return program_trace.host_syncs_per_iteration(ctx)
