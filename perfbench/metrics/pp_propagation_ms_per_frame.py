"""pp_propagation_ms_per_frame: device milliseconds a returned frame in the
program's ``vsr.pp.propagate`` spans, image propagation, the flow warps
gated by the consistency check (``_propagate_images``): the time between
CUDA events at the span's edges, recorded while the traced run's profiler
records. Layer: ProPainter stages; it moves fps. None off a card and where
the program records no ProPainter spans (``perfbench/pp_spans.py``)."""

from perfbench.pp_spans import ms_per_frame

LAYER = "ProPainter stages"
UNIT = "ms/frame"
MOVES = "fps"


def read(ctx):
    return ms_per_frame(ctx, ["vsr.pp.propagate"], device=True)
