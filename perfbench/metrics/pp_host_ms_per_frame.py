"""pp_host_ms_per_frame: host milliseconds a returned frame in the
program's ``vsr.pp.prepare`` and ``vsr.pp.finish`` spans: the frame copies,
the band crop, the mask dilation and the H2D before the stages, the D2H
and the paste after them. Layer: ProPainter host band path; it moves fps.
None off a card and where the program records no ProPainter spans
(``perfbench/pp_spans.py``)."""

from perfbench.pp_spans import ms_per_frame

LAYER = "ProPainter host band path"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, ["vsr.pp.prepare", "vsr.pp.finish"])
