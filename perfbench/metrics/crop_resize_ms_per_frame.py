"""crop_resize_ms_per_frame: milliseconds a frame in the program's
``vsr.crop_resize`` spans, cropping each frame's band and resizing it to the
model's 640x120 (`STTNAutoInpainter._stack_band`, `native.crop_resize`).
Layer: STTN host band path; it moves fps. None off a card and where the
program records no spans (``perfbench/program_spans.py``)."""

from perfbench.program_spans import ms_per_frame

LAYER = "STTN host band path"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, "vsr.crop_resize")
