"""fetch_wait_ms_per_frame: milliseconds a frame in the program's ``vsr.fetch``
spans, the wait on each chunk's event in `STTNWindowEngine.fetch`: the time
the host waited for the card. Layer: engine; it moves fps. None off a card
and where the program records no spans (``perfbench/program_spans.py``)."""

from perfbench.program_spans import ms_per_frame

LAYER = "engine"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, "vsr.fetch")
