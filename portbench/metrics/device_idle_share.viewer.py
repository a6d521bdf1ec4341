"""The share of the profiled stretch in which no kernel, memcpy or memset
ran on the device (viewer cells)."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
