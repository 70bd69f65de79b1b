"""Bilinear 2x upsampling with align_corners=True (the reference decoder's
``F.interpolate``); counterpart of ``vsr_tpu/ops/upsample.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x upsample of an NCHW tensor: src = dst * (H_in - 1) / (H_out - 1)."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=True)
