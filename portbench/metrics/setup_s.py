"""Process start to the first timed frame: torch and the device, the
scene's glTF load and compile, the renderers, the kernels' libraries
and the graph captures of the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
