"""Frames presented over the window, from its start to the last present
(host clock)."""


def read(ctx):
    return (ctx.count["frames"] / ctx.clock.elapsed
            if ctx.count["frames"] else None)
