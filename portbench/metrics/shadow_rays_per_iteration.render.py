"""NEE shadow rays cast per wavefront iteration, by the program's own
device counter brought into its trace window (render cells with NEE):
the traffic behind ``shadow_ms.render``.  None where the window has no
such counter."""

from portbench import shade_trace


def read(ctx):
    return shade_trace.shadow_rays_per_iteration(ctx)
