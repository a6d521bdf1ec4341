"""The (tile, box) pairs the NEE shadow rays' worklist prepass fires per
wavefront iteration (the frustum prepass before K4 on the streamed
route, the worklist kernel before K1 on the resident one), by the
program's own device counter brought into its trace window (render
cells with NEE).  With the same answers, fewer pairs means the prepass
culls more; beside ``shadow_rays_per_iteration.render`` it tells a
``shadow_ms.render`` change in the prepass from one in the any-hit
kernel.  None where the window has no such counter."""

from portbench import program_trace


def read(ctx):
    w = program_trace.window(ctx)
    if not w or not w.get("iterations") or "shadow_clusters" not in w:
        return None
    return w["shadow_clusters"] / w["iterations"]
