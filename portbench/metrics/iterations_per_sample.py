"""Wavefront iterations (steps and drains, last_iterations summed) per
full-frame sample."""

from portbench import readers


def read(ctx):
    return readers.iterations_per(ctx, "samples")
