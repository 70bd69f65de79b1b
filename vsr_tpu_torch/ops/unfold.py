"""Unfold (im2col) / fold (col2im): counterpart of ``vsr_tpu/ops/unfold.py``.

ProPainter's SoftSplit / SoftComp tokenisation and FusionFeedForward's
renormalisation are unfold / fold round trips (the reference's
sparse_transformer.py:7-101). Token features are ordered channel-major
(c, kh, kw), F.unfold's order and the JAX package's. Images are NCHW;
tokens are channels-last [B, oh, ow, C*kh*kw], as the linear layers that
read and write them want.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def unfold_output_size(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - (k - 1) - 1) // s + 1


def unfold(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
           padding: Tuple[int, int]) -> torch.Tensor:
    """x [B, C, H, W] -> tokens [B, oh, ow, C*kh*kw]."""
    B, _, H, W = x.shape
    oh = unfold_output_size(H, kernel[0], stride[0], padding[0])
    ow = unfold_output_size(W, kernel[1], stride[1], padding[1])
    cols = F.unfold(x, kernel, padding=padding, stride=stride)  # [B, C*kh*kw, oh*ow]
    return cols.transpose(1, 2).reshape(B, oh, ow, -1)


def fold(tokens: torch.Tensor, out_hw: Tuple[int, int], kernel: Tuple[int, int],
         stride: Tuple[int, int], padding: Tuple[int, int]) -> torch.Tensor:
    """tokens [B, oh, ow, C*kh*kw] -> [B, C, H, W] by overlap-add."""
    B, oh, ow, ck = tokens.shape
    cols = tokens.reshape(B, oh * ow, ck).transpose(1, 2)
    return F.fold(cols, out_hw, kernel, padding=padding, stride=stride)


def fold_normalizer(out_hw: Tuple[int, int], kernel: Tuple[int, int],
                    stride: Tuple[int, int], padding: Tuple[int, int], oh: int, ow: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """fold(ones), [1, 1, H, W]: the per-pixel overlap count."""
    ones = torch.ones((1, oh, ow, kernel[0] * kernel[1]), dtype=dtype, device=device)
    return fold(ones, out_hw, kernel, stride, padding)
