"""token_attention_roofline_pct: the token-attention kernel's share of its
roofline over the traced window: the sum over its calls of the least time
(counts.token_attention_bound_s, from each call's B, Nq, Nk, D and dtype)
over the device time of the kernels that implement it. The bf16 route is
``score_kernel`` then ``pv_kernel`` (csrc/token_attention.cu); the fp32
route adds ``split_kernel`` and runs ``score_f32_kernel`` and
``pv_f32_kernel``. Layer: kernel (``ops/token_attention.py``); it moves
fps. Calls are read by the harness's recorder around
``ops.patch_attention.flash_token_attention``."""

from perfbench import counts
from perfbench.harness import kernel_seconds

LAYER = "kernel"
UNIT = "%"
MOVES = "fps"
KERNELS = ("score_kernel", "pv_kernel", "split_kernel", "score_f32_kernel", "pv_f32_kernel")


def read(ctx):
    card = counts.peaks(ctx.card["kind"])
    rec = ctx.recorders.get("flash_token_attention")
    if card is None or rec is None or not rec.calls:
        return None
    seconds = kernel_seconds(ctx.trace, KERNELS)
    if seconds <= 0:
        return None
    bound = sum(counts.token_attention_bound_s(*call, card) for call in rec.calls)
    return 100.0 * bound / seconds
