"""A CPU model of the fp32 token-attention route's sums on the tensor cores.

    python scripts/tf32_sum_model.py

The route (vsr_tpu_torch/csrc/token_attention.cu) runs fp32 products as
3xTF32 on wgmma: operands split into rounded tf32 hi and lo parts, each
product lo hi + hi lo + hi hi. The tensor cores add each k8 step's products
to the fp32 accumulator with truncation (rounding toward zero), so over
hundreds of steps the error builds up one way. This script models that: each
k8 step's three partial products are summed exactly (float64) and added to
the accumulator, which is then truncated to fp32. It runs the route's steps
(q k^T, per-128-key-tile softmax statistics, the merge, p v with each tile's
factor) on 16 query rows at two of the path's shapes, with one accumulator
for the whole sum (in p v with p scaled first: the route's first build) or
a fresh accumulator per 32-deep stage whose sum is added in rounded fp32
(in p v scaled by the key tile's factor: the kernel's design), in q k^T, in
p v or both, and prints the max error against token_attention_reference and
its ratio to the card check's limit 2e-5 (1 + |ref|). CPU arithmetic only:
no device numbers. Takes a few minutes.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vsr_tpu_torch.ops.token_attention import token_attention_reference  # noqa: E402

LOG2E = np.float32(1.4426950408889634)
STAGE_STEPS = 4  # k8 steps in one 32-deep stage
ROWS, SEED = 16, 0
SHAPES = {"(10,5)": (1536, 3200), "(5,3)": (5120, 960)}


def tf32(x):
    """Round to tf32 as cvt.rna.tf32.f32: to nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(x):
    """float64 -> the fp32 next to it toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tensor_core_matmul(a, b, per_stage):
    """a @ b in 3xTF32 with truncating sums per k8 step; per_stage: a fresh
    accumulator each STAGE_STEPS steps, added to the total in rounded fp32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for j in range(a.shape[1] // 8):
        ks = slice(8 * j, 8 * j + 8)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = truncate(acc.astype(np.float64) + x[:, ks].astype(np.float64) @ y[ks])
        if per_stage and (j + 1) % STAGE_STEPS == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def route(q, k, v, bias, per_stage_scores, per_stage_pv, tile=128):
    scale_log2 = np.float32(1.0 / math.sqrt(q.shape[1])) * LOG2E
    s = tensor_core_matmul(q, k.T, per_stage_scores) * scale_log2 + bias * LOG2E
    tiles = [s[:, i:i + tile] for i in range(0, s.shape[1], tile)]
    m_t = [t.max(axis=1, keepdims=True) for t in tiles]
    p_t = [np.exp2(t - m) for t, m in zip(tiles, m_t)]
    m = np.max(np.concatenate(m_t, axis=1), axis=1, keepdims=True)
    l = sum(p.sum(axis=1, keepdims=True) * np.exp2(mt - m) for p, mt in zip(p_t, m_t))
    f_t = [np.exp2(mt - m) / l for mt in m_t]
    if not per_stage_pv:  # p scaled first, then one accumulator over every key
        return tensor_core_matmul(np.concatenate([p * f for p, f in zip(p_t, f_t)], axis=1),
                                  v, False)
    # the kernel: each stage from raw p, its sum scaled by the key tile's factor
    return sum(tensor_core_matmul(p, v[i * tile:(i + 1) * tile], True) * f
               for i, (p, f) in enumerate(zip(p_t, f_t)))


def main() -> int:
    rng = np.random.default_rng(SEED)
    for name, (n, d) in SHAPES.items():
        q = rng.standard_normal((ROWS, d)).astype(np.float32)
        k, v = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(2))
        bias = np.where(rng.random((1, n)) < 0.3, -1e9, 0.0).astype(np.float32)
        ref = token_attention_reference(
            *(torch.from_numpy(x)[None] for x in (q, k, v, bias))).numpy()[0]
        for scores, pv in ((False, False), (True, False), (False, True), (True, True)):
            err = np.abs(route(q, k, v, bias, scores, pv) - ref)
            ratio = (err / (2e-5 * (1 + np.abs(ref)))).max()
            print(f"{name} N={n} D={d}, {ROWS} query rows; a fresh accumulator per stage in "
                  f"q k^T: {scores}, in p v: {pv}: max |err| {err.max():.3e}, "
                  f"{ratio:.3f} of the limit", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
