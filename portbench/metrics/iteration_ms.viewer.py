"""The window's wall time per wavefront iteration (viewer cells)."""

from portbench import readers


def read(ctx):
    return readers.iteration_ms(ctx)
