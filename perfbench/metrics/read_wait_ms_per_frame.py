"""read_wait_ms_per_frame: milliseconds a frame in the program's ``vsr.read``
spans, the reads that fill each chunk (`read_chunk` in
`STTNAutoInpainter.process_video`): waiting on the decoder, here the
benchmark's reader and its frame copies. Layer: STTN host band path; it
moves fps. None off a card and where the program records no spans
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import ms_per_frame

LAYER = "STTN host band path"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, "vsr.read")
