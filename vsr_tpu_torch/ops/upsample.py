"""Bilinear upsampling with align_corners=True (the reference decoder's
``F.interpolate``); counterpart of ``vsr_tpu/ops/upsample.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize an NCHW tensor to [..., out_h, out_w], align-corners bilinear:
    src = dst * (H_in - 1) / (H_out - 1)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def upsample_bilinear_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x upsample of an NCHW tensor."""
    h, w = x.shape[-2:]
    return upsample_bilinear_align_corners(x, 2 * h, 2 * w)
