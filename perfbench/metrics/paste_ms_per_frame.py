"""paste_ms_per_frame: milliseconds a frame in the program's ``vsr.paste``
spans, blending each frame's inpainted band back under the mask
(`paste_band`, `native.paste_band_blend`). Layer: STTN host band path; it
moves fps. None off a card and where the program records no spans
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import ms_per_frame

LAYER = "STTN host band path"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, "vsr.paste")
