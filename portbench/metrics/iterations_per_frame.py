"""Wavefront iterations (steps and drains, last_iterations summed) per
presented frame."""

from portbench import readers


def read(ctx):
    return readers.iterations_per(ctx, "frames")
