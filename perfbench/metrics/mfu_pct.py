"""mfu_pct: the model step's share of the card's bf16 peak over the traced
window: counts.py's model FLOPs of every chunk the window ran (the published
schedule's work, padding left out) over the window's wall time times the
data-sheet peak (989 TFLOP/s bf16 dense on an H100 SXM). Layer: the model
step (``models/sttn.py``); it moves fps."""

from perfbench import counts

LAYER = "model step"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    card = counts.peaks(ctx.card["kind"])
    if card is None or not ctx.work:
        return None
    flops = sum(bands * counts.chunk_flops(frames, ctx.cfg) for frames, _, bands in ctx.work)
    return 100.0 * flops / (ctx.trace.window_s * card["bf16_flops"])
