"""dispatch_ms_per_frame: milliseconds a frame in the program's
``vsr.dispatch`` spans, `STTNWindowEngine.dispatch`: pinned staging, the
window indices, the H2D copies and the launch of the chunk's kernels (its
children `vsr.stage` and `vsr.launch`). Layer: engine; it moves fps. None
off a card and where the program records no spans
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import ms_per_frame

LAYER = "engine"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, "vsr.dispatch")
