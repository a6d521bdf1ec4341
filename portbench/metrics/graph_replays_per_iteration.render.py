"""CUDA graph replays (GraphCache.replays) in the window per wavefront
iteration (render cells)."""

from portbench import readers


def read(ctx):
    return readers.replays_per_iteration(ctx)
