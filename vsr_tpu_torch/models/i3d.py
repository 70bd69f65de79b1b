"""Inflated 3D Inception (I3D), the VFID metric's feature extractor: counterpart
of ``vsr_tpu/models/i3d.py`` (the reference's InceptionI3d,
backend/inpaint/video/core/metrics.py:62-67,85-334): Inception-v1 inflated to
3D, conv + BatchNorm + ReLU units, nine Mixed blocks, a 400-way logits head.

Input is ``vsr_tpu``'s: [B, T, H, W, 3] in [-1, 1] (T >= 9 at 224x224);
the convolutions run NCDHW inside. Three details carry over exactly:

* TF-"SAME" padding computed from each layer's input shape, the extra
  pixel at the back (``_same_pads``);
* max pools pad with 0, not -inf, before a VALID pool (the reference's
  ``F.pad`` then ``MaxPool3d``);
* BatchNorm with eps 1e-3 and torch momentum 0.01 (flax's 0.99). VFID runs
  the network in eval mode; in train mode torch updates the running
  variance with the unbiased batch variance (the reference's rule), flax
  with the biased one.

Modules carry the reference checkpoint's names (``Conv3d_1a_7x7.conv3d``,
``Mixed_3b.b0.bn``, ``Mixed_4f.b3b.conv3d``, ...). The logits head is a
``Linear`` named ``logits`` (the JAX package's Dense over the pooled
features); the reference's 1x1x1 ``logits.conv3d`` loads into it, so an
``i3d_rgb_imagenet.pt`` state dict loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Triple = Tuple[int, int, int]


def _same_pads(shape: Sequence[int], kernel: Triple, stride: Triple) -> Tuple[int, ...]:
    """TF-"SAME" pads of a [T, H, W] input in ``F.pad``'s order (W front,
    W back, H ..., T ...): total k - s when the size divides the stride,
    else k - size % s; the front gets total // 2."""
    pads = []
    for dim, k, s in zip(shape, kernel, stride):
        total = max(k - s, 0) if dim % s == 0 else max(k - dim % s, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for pair in reversed(pads) for p in pair)


def _max_pool_3d(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    """SAME max pool over [B, C, T, H, W], zero-padded first."""
    x = F.pad(x, _same_pads(x.shape[2:], kernel, stride))
    return F.max_pool3d(x, kernel, stride)


class Unit3D(nn.Module):
    """SAME Conv3d (no bias) + BatchNorm3d + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Triple = (1, 1, 1),
                 stride: Triple = (1, 1, 1)):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=False)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, _same_pads(x.shape[2:], self.kernel, self.stride))
        return torch.relu(self.bn(self.conv3d(x)))


class InceptionBlock(nn.Module):
    """Four branches: 1x1 | 1x1 -> 3x3 | 1x1 -> 3x3 | 3x3 pool -> 1x1."""

    def __init__(self, cin: int, widths: Sequence[int]):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3 = widths
        self.b0 = Unit3D(cin, b0)
        self.b1a = Unit3D(cin, b1a)
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.b2a = Unit3D(cin, b2a)
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.b3b = Unit3D(cin, b3)
        self.out_channels = b0 + b1b + b2b + b3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y3 = self.b3b(_max_pool_3d(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), y3], dim=1)


MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
# the max pool before each stage of Mixed blocks: (kernel, stride)
_STAGE_POOLS = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)), "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3d(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, widths in MIXED.items():
            block = InceptionBlock(cin, widths)
            self.add_module(name, block)
            cin = block.out_channels
        self.logits = nn.Linear(cin, num_classes)
        self._register_load_state_dict_pre_hook(self._reference_logits)

    @staticmethod
    def _reference_logits(state_dict, prefix, *args):
        """The reference's 1x1x1 ``logits.conv3d`` -> this ``Linear``."""
        for leaf in ("weight", "bias"):
            value = state_dict.pop(f"{prefix}logits.conv3d.{leaf}", None)
            if value is not None:
                state_dict[f"{prefix}logits.{leaf}"] = value.reshape(value.shape[0], -1) \
                    if leaf == "weight" else value

    def forward(self, video: torch.Tensor, features_only: bool = True) -> torch.Tensor:
        """video [B, T, H, W, 3] in [-1, 1] -> pooled features [B, 1024]
        (``features_only``) or logits [B, num_classes]."""
        x = video.permute(0, 4, 1, 2, 3).to(self.logits.weight.dtype)
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name in MIXED:
            if name in _STAGE_POOLS:
                x = _max_pool_3d(x, *_STAGE_POOLS[name])
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3, 4))
        return feats if features_only else self.logits(feats)
