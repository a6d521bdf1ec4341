"""K2's share of its roofline over the profiled stretch: the bound of the
lanes it shaded (peaks.shade_bound) over its device time (viewer
cells)."""

from portbench import readers


def read(ctx):
    return readers.shade_roofline(ctx)
