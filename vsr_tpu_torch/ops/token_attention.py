"""Token attention over pre-tokenized patch tokens: the hand-written CUDA
kernel (``csrc/token_attention.cu``) and its plain PyTorch version.

Counterpart of ``vsr_tpu/ops/pallas_token_attention.py``. The TPU kernel's
block-size snapping, (8, 128) padding and interpret mode have no place here:
the CUDA kernel masks its ragged query and key edges itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Kernel launches since import (or since a caller reset it to 0). Incremented
# once per launch of the CUDA kernel and nowhere else, so a run can show that
# its main path went through the kernel.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def token_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + key_bias) v, all in fp32, cast to q.dtype.

    q: [B, Nq, D]; k, v: [B, Nk, D]; key_bias: [B, Nk] additive (0 / -1e9).
    The same arithmetic as the Pallas kernel body
    (vsr_tpu/ops/pallas_token_attention.py:61-85)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if key_bias is not None:
        scores = scores + key_bias.float()[:, None, :]
    attn = torch.softmax(scores, dim=-1)
    return torch.matmul(attn, v.float()).to(q.dtype)


def _check(q, k, v, key_bias) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B, N, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"token attention takes float32 or bfloat16, got {q.dtype}")
    B, Nq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if min(B, Nq, k.shape[1], D) == 0:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if key_bias is not None:
        if key_bias.device != q.device or key_bias.dtype != torch.float32:
            raise TypeError("key_bias must be float32 on q's device")
        if tuple(key_bias.shape) != (B, k.shape[1]) or not key_bias.is_contiguous():
            raise ValueError(f"key_bias must be a contiguous [B, Nk] = "
                             f"{(B, k.shape[1])}, got {tuple(key_bias.shape)}")


def flash_token_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + key_bias) v over token matrices.

    q: [B, Nq, D], k/v: [B, Nk, D] in float32 or bfloat16, contiguous;
    key_bias: optional contiguous float32 [B, Nk]. Returns [B, Nq, D] in
    q.dtype. A CUDA tensor runs the CUDA kernel (or raises); a CPU tensor
    runs token_attention_reference.
    """
    if q.device.type == "cpu":
        return token_attention_reference(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"no token-attention kernel for device {q.device}")
    _check(q, k, v, key_bias)
    from vsr_tpu_torch.ops._build import get_lib

    lib = get_lib()
    fn = lib.token_attention_bf16 if q.dtype == torch.bfloat16 else lib.token_attention_f32
    B, Nq, D = q.shape
    Nk = k.shape[1]
    splits = lib.token_attention_splits(B, Nq, Nk, q.device.index)
    if splits <= 0:
        raise RuntimeError(f"token attention: cudaError_t {-splits} reading the device")
    out = torch.empty_like(q)
    # per key split: each query row's softmax max and sum over that split's keys
    stats = torch.empty((2, splits, B, Nq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             key_bias.data_ptr() if key_bias is not None else None,
             out.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
             B, Nq, Nk, D, splits, 1.0 / math.sqrt(D), q.device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"token attention kernel launch failed: cudaError_t {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)})")
    global launches
    launches += 1
    return out
