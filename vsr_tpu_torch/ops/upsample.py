"""Bilinear upsampling with align_corners=True (the reference decoder's
``F.interpolate``); counterpart of ``vsr_tpu/ops/upsample.py``.

The forward is ``F.interpolate`` itself. The backward is not PyTorch's
``upsample_bilinear2d_backward``, which sums with atomic adds on CUDA and so
differs in the last bits from run to run (STTN training then parts, ROADMAP
F7): align-corners resampling is linear, out = A_h x A_w^T with static
interpolation matrices, so the input gradient is A_h^T g A_w, two matmuls
with no atomics."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def interpolation_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of align-corners linear resampling along one
    axis, src = dst * (n_in - 1) / (n_out - 1) (vsr_tpu/ops/upsample.py:19-29),
    formed in fp32 as PyTorch's bilinear kernels form them (scale, source
    coordinate and lambda all fp32), so the matrix is the forward's own:
    vsr_tpu forms src in fp64 and differs by fp32's rounding of src."""
    one = np.float32(1)
    scale = np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0)
    src = scale * np.arange(n_out, dtype=np.float32)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    lam = np.clip(src - i0.astype(np.float32), 0, one)
    a = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(a, (rows, i0), one - lam)
    np.add.at(a, (rows, i1), lam)
    return a


@functools.lru_cache(maxsize=64)
def _matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(interpolation_matrix(n_in, n_out)).to(device)


class _AlignCornersUpsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_h: int, out_w: int):
        ctx.in_hw = x.shape[-2:]
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)

    @staticmethod
    def backward(ctx, grad):
        (h, w), (out_h, out_w) = ctx.in_hw, grad.shape[-2:]
        a_h = _matrix(h, out_h, grad.device)
        a_w = _matrix(w, out_w, grad.device)
        # fp32 products: exact to fp32 rounding only with TF32 off, as the
        # trainers run (torch.backends.cuda.matmul.allow_tf32 = False)
        g = grad.float() @ a_w  # [..., out_h, w]
        g = (g.transpose(-1, -2) @ a_h).transpose(-1, -2)  # [..., h, w]
        return g.contiguous().to(grad.dtype), None, None


def upsample_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize an NCHW tensor to [..., out_h, out_w], align-corners bilinear:
    src = dst * (H_in - 1) / (H_out - 1). The forward is F.interpolate's; the
    backward is deterministic (see the module docstring)."""
    return _AlignCornersUpsample.apply(x, out_h, out_w)


def upsample_bilinear_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x upsample of an NCHW tensor."""
    h, w = x.shape[-2:]
    return upsample_bilinear_align_corners(x, 2 * h, 2 * w)
