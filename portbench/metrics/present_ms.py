"""Present: host time from the image_u8() call (with its drain) to the
frame's bytes on the host through the pinned copy, per frame (spans
around the calls)."""

from portbench import readers


def read(ctx):
    return readers.present_ms(ctx)
