"""The NEE shadow rays (their worklist kernel, K1 in any-hit mode, their
count and the visibility add) in device ms per wavefront iteration, by
the program's stopwatch inside the captured stages (render cells with
NEE).  None where the program's window has no ``shadow`` slot."""

from portbench import shade_trace


def read(ctx):
    return shade_trace.slot_ms(ctx, "shadow")
