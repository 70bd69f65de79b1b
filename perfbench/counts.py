"""Work counts from shapes alone, so they read the same whatever implements
the work: the STTN model's FLOPs per chunk, and the token-attention
kernel's operations, bytes and least time per launch.

Model FLOPs count what the published schedule needs (reference/pipeline.py):
every frame of a chunk encoded once, each window's transformer over its own
neighbour and reference frames, each window's neighbour slots decoded. A
multiply-add is two operations; convolutions and matmuls are counted, as
``torch.utils.flop_counter`` counts them; activations, softmax, upsampling
and the composite are not.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

from perfbench.reference.pipeline import windows

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_kind: str) -> Optional[Dict[str, float]]:
    """The data-sheet peaks of a card by its name, or None for a card the
    table does not hold."""
    with open(PEAKS_FILE) as f:
        return json.load(f)["cards"].get(device_kind)


def conv_flops(n: int, cin: int, cout: int, k: int, h: int, w: int) -> int:
    """A k x k convolution producing [n, cout, h, w]."""
    return 2 * n * cin * cout * k * k * h * w


def encoder_flops(H: int, W: int, channel: int) -> int:
    """One frame through the stride-4 encoder."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    return (conv_flops(1, 3, 64, 3, h2, w2) + conv_flops(1, 64, 64, 3, h2, w2)
            + conv_flops(1, 64, 128, 3, h4, w4) + conv_flops(1, 128, channel, 3, h4, w4))


def decoder_flops(H: int, W: int, channel: int) -> int:
    """One frame's features through the decoder."""
    h2, w2 = H // 2, W // 2
    return (conv_flops(1, channel, 128, 3, h2, w2) + conv_flops(1, 128, 64, 3, h2, w2)
            + conv_flops(1, 64, 64, 3, H, W) + conv_flops(1, 64, 3, 3, H, W))


def attention_scales(H: int, W: int, channel: int,
                     patch_sizes: Sequence[Sequence[int]]) -> Iterable[Tuple[int, int]]:
    """(tokens per frame, token width D) of each patch scale."""
    h, w = H // 4, W // 4
    d_k = channel // len(patch_sizes)
    for pw, ph in patch_sizes:
        yield (h // ph) * (w // pw), ph * pw * d_k


def block_flops(frames: int, H: int, W: int, channel: int,
                patch_sizes: Sequence[Sequence[int]]) -> int:
    """One transformer block over a window of ``frames`` frames."""
    h, w = H // 4, W // 4
    convs = (3 * conv_flops(frames, channel, channel, 1, h, w)      # q, k, v
             + conv_flops(frames, channel, channel, 3, h, w)        # output
             + 2 * conv_flops(frames, channel, channel, 3, h, w))   # feed-forward
    attn = 0
    for per_frame, D in attention_scales(H, W, channel, patch_sizes):
        n = frames * per_frame
        attn += 4 * n * n * D
    return convs + attn


def chunk_flops(t: int, cfg: dict) -> int:
    """Model FLOPs of one t-frame chunk under the published schedule."""
    W, H = cfg["input_size"]
    c, ps = cfg["channel"], cfg["patch_sizes"]
    total = t * encoder_flops(H, W, c)
    for nbrs, refs in windows(t, cfg["neighbor_stride"], cfg["ref_length"]):
        total += cfg["blocks"] * block_flops(len(nbrs) + len(refs), H, W, c, ps)
        total += len(nbrs) * decoder_flops(H, W, c)
    return total


def token_attention_work(B: int, Nq: int, Nk: int, D: int, itemsize: int,
                         bias: bool) -> Tuple[int, int]:
    """(operations, bytes) of one launch: 4 B Nq Nk D operations (q k^T and
    p v); q, k, v and the output moved once, and the fp32 key bias."""
    ops = 4 * B * Nq * Nk * D
    nbytes = itemsize * B * D * (2 * Nq + 2 * Nk) + (4 * B * Nk if bias else 0)
    return ops, nbytes


def token_attention_bound_s(B: int, Nq: int, Nk: int, D: int, itemsize: int, bias: bool,
                            card: Dict[str, float]) -> float:
    """The least time of one launch on ``card``: the larger of its
    operations over the peak of its dtype's route and its bytes over the
    memory bandwidth. bf16 runs on the bf16 tensor-core peak; fp32 runs as
    three TF32 products (3xTF32), so three times the operations at the TF32
    peak."""
    ops, nbytes = token_attention_work(B, Nq, Nk, D, itemsize, bias)
    compute = ops / card["bf16_flops"] if itemsize == 2 else 3 * ops / card["tf32_flops"]
    return max(compute, nbytes / card["hbm_bytes_per_s"])


def token_attention_launches(work: Iterable[Tuple[int, int, int]], cfg: dict) -> int:
    """Launches of the token-attention kernel that the chunks ``work`` (each
    (frames, chunk length, bands), a driver's ``chunk_work``) need: one per
    window, block and kernel scale (``kernel_patch_sizes``) in every band
    of every chunk, each chunk holding ceil(length / stride) windows."""
    per_window = cfg["blocks"] * len(cfg["kernel_patch_sizes"])
    stride = cfg["neighbor_stride"]
    return sum(bands * per_window * -(-length // stride) for _, length, bands in work)
