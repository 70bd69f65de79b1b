"""pp_completion_ms_per_frame: device milliseconds a returned frame in the
program's ``vsr.pp.complete`` spans, the recurrent flow completion of every
sub-video (``_complete_flows``): the time between CUDA events at the span's
edges, recorded while the traced run's profiler records. Layer: ProPainter
stages; it moves fps. None off a card and where the program records no
ProPainter spans (``perfbench/pp_spans.py``)."""

from perfbench.pp_spans import ms_per_frame

LAYER = "ProPainter stages"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, ["vsr.pp.complete"], device=True)
