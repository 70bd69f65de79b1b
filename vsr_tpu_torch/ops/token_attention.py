"""Token attention over pre-tokenized patch tokens: the hand-written CUDA
kernel (``csrc/token_attention.cu``) and its plain PyTorch version.

Counterpart of ``vsr_tpu/ops/pallas_token_attention.py``. The TPU kernel's
block-size snapping, (8, 128) padding and interpret mode have no place here:
the CUDA kernels mask their ragged query and key edges themselves. Both
routes are TMA + wgmma: a score kernel that writes p, then a p v kernel;
bf16 inputs keep p in bf16, fp32 inputs keep it in fp32 and run every
product as three tf32 products of split operands (3xTF32, after a pass that
splits k and v^T). The tensor maps need D % 8 == 0 (bf16) or D % 4 == 0
(fp32) and 16-byte aligned bases, so other inputs are first copied into an
aligned buffer zero-padded in D (the scale stays 1/sqrt of the true D).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

# Kernel launches since import (or since a caller reset it to 0). Incremented
# once per launch of the CUDA kernel and nowhere else, so a run can show that
# its main path went through the kernel.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)

# csrc/token_attention.cu returns this plus the CUresult when a tensor map
# cannot be made.
TENSOR_MAP_ERROR = 10000


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


def _forward_only(q, k, v) -> None:
    """The CUDA kernel has no backward: its output carries no autograd
    graph, so a caller that needs gradients through attention would lose
    them without a word. Raise instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the token-attention CUDA kernel is forward-only and q, k or v requires grad: "
            "run under torch.no_grad() / torch.inference_mode(), or build the model with "
            "use_kernel=False for training")


def _aligned(t: torch.Tensor, D_pad: int) -> torch.Tensor:
    """t itself when the kernel's tensor maps can read it (D == D_pad and a
    16-byte aligned base), else a fresh copy zero-padded to D_pad columns."""
    if t.shape[-1] == D_pad and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(t.shape[:-1] + (D_pad,))
    out[..., :t.shape[-1]] = t
    return out


@functools.lru_cache(maxsize=None)
def _tiles(lib, fp32: bool = False) -> Tuple[int, int]:
    """(query rows, keys) of the bf16 (or fp32) route's scratch tiles."""
    rows, keys = ctypes.c_int(), ctypes.c_int()
    lib.token_attention_tiles(int(fp32), ctypes.byref(rows), ctypes.byref(keys))
    return rows.value, keys.value


def _bf16_attention(lib, q, k, v, key_bias, scale: float) -> torch.Tensor:
    """The bf16 route: score kernel, then p v kernel (csrc/token_attention.cu)."""
    B, Nq, D = q.shape
    Nk = k.shape[1]
    D_pad = -(-D // 8) * 8
    q, k, v = (_aligned(t, D_pad) for t in (q, k, v))
    rows, keys = _tiles(lib)
    k_tiles, nq_pad = -(-Nk // keys), -(-Nq // rows) * rows
    out = torch.empty((B, Nq, D_pad), dtype=q.dtype, device=q.device)
    # p = exp(s - m_t) per score tile, and each tile's row max m_t and sum l_t
    p = torch.empty((B, Nq, k_tiles * keys), dtype=torch.bfloat16, device=q.device)
    part = torch.empty((2, B, k_tiles, nq_pad), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    err = lib.token_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None,
        out.data_ptr(), p.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        B, Nq, Nk, D_pad, scale, q.device.index, stream.cuda_stream)
    _raise_on(err, q, k)
    return out if D_pad == D else out[..., :D].contiguous()


def _f32_attention(lib, q, k, v, key_bias, scale: float) -> torch.Tensor:
    """The fp32 route: split pass, score kernel, then p v kernel, products
    in 3xTF32 on wgmma (csrc/token_attention.cu)."""
    B, Nq, D = q.shape
    Nk = k.shape[1]
    D_pad = -(-D // 4) * 4
    q, k, v = (_aligned(t, D_pad) for t in (q, k, v))
    rows, keys = _tiles(lib, fp32=True)
    k_tiles, nq_pad = -(-Nk // keys), -(-Nq // rows) * rows
    nk_pad = k_tiles * keys
    empty = functools.partial(torch.empty, dtype=torch.float32, device=q.device)
    out = empty((B, Nq, D_pad))
    # p = exp(s - m_t) per score tile, and each tile's row max m_t and sum l_t
    p = empty((B, Nq, nk_pad))
    part = empty((2, B, k_tiles, nq_pad))
    # tf32 hi and lo parts of k, and of v^T (keys contiguous, zero past Nk)
    k_split = empty((2, B, Nk, D_pad))
    vt_split = empty((2, B, D_pad, nk_pad))
    stream = torch.cuda.current_stream(q.device)
    err = lib.token_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None,
        out.data_ptr(), p.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        k_split.data_ptr(), vt_split.data_ptr(),
        B, Nq, Nk, D_pad, scale, q.device.index, stream.cuda_stream)
    _raise_on(err, q, k)
    return out if D_pad == D else out[..., :D].contiguous()


def _raise_on(err: int, q, k) -> None:
    if err != 0:
        what = (f"tensor map CUresult {err - TENSOR_MAP_ERROR}" if err >= TENSOR_MAP_ERROR
                else f"cudaError_t {err}")
        raise RuntimeError(f"token attention kernel launch failed: {what} "
                           f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)})")


def flash_token_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + key_bias) v over token matrices.

    q: [B, Nq, D], k/v: [B, Nk, D] in float32 or bfloat16, contiguous;
    key_bias: optional contiguous float32 [B, Nk]. Returns [B, Nq, D] in
    q.dtype. A CUDA tensor runs the CUDA kernels (or raises); a CPU tensor
    runs token_attention_reference. One call counts one launch, whatever
    number of CUDA kernels it runs. The kernels are forward-only: on CUDA,
    q, k or v requiring grad with grad mode on raises (_forward_only).
    """
    if q.device.type == "cpu":
        return token_attention_reference(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"no token-attention kernel for device {q.device}")
    _check(q, k, v, key_bias)
    _forward_only(q, k, v)
    from vsr_tpu_torch.ops._build import get_lib

    lib = get_lib()
    scale = 1.0 / math.sqrt(q.shape[-1])
    route = _bf16_attention if q.dtype == torch.bfloat16 else _f32_attention
    out = route(lib, q, k, v, key_bias, scale)
    global launches
    launches += 1
    return out
