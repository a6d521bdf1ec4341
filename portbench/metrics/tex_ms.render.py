"""The texture prologue (render/megakernel.py ``resolve_tex_prologue``,
ops/texture.py) in device ms per wavefront iteration, by the program's
stopwatch inside the captured stages (render cells with textures).  None
where the program's window has no ``tex`` slot (a program that does not
time it, or a run off the card)."""

from portbench import shade_trace


def read(ctx):
    return shade_trace.slot_ms(ctx, "tex")
