"""Full-frame samples completed over the window, from its start to the
end of its last frame or render (host clock)."""


def read(ctx):
    return (ctx.count["samples"] / ctx.clock.elapsed
            if ctx.count["samples"] else None)
