"""mfu_pct: the model step's share of the card's bf16 peak over the traced
window: the useful model FLOPs of every chunk the window ran, as the
configuration's driver counts them from shapes alone (``model_flops``; for
STTN counts.py's published schedule, padding left out), over the window's
wall time times the data-sheet peak (989 TFLOP/s bf16 dense on an H100
SXM). One yardstick in every cell, whatever dtype the cell computes in.
Layer: the model step (``models/sttn.py``); it moves fps."""

from perfbench import counts

LAYER = "model step"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    card = counts.peaks(ctx.card["kind"])
    if card is None or not ctx.model_flops:
        return None
    return 100.0 * ctx.model_flops / (ctx.trace.window_s * card["bf16_flops"])
