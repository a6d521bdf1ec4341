"""The intersect kernels' (K1 and its worklist kernel, K4-K8) share of
their roofline over the profiled stretch: the bound of the rays they
served (peaks.intersect_bound) over their device time (viewer cells)."""

from portbench import readers


def read(ctx):
    return readers.intersect_roofline(ctx)
