"""The 95th percentile of the interval between two presents, over every
frame of the window (host clock)."""

from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx.clock.intervals)
