"""The PP-OCRv5 detectors' necks (PyTorch): RSEFPN (mobile preset) and
LKPAN (server preset).

Counterpart of ``vsr_tpu/detect/necks.py`` (PaddleOCR db_fpn.RSEFPN with
shortcut, and db_fpn.LKPAN, mode='large', with the necks/intracl.py
IntraCLBlock that the server preset always uses).
Each takes the backbone's four stride-4/8/16/32 maps and returns the
stride-4 fused map of ``out_channels`` channels (four quarters
concatenated). NCHW; module names are the flax ones. Nearest upsampling by
an integer factor is a repeat along H and W, as ``jnp.repeat`` in the JAX
package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.detect.backbones import hard_sigmoid


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, factor*H, factor*W], each pixel repeated."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def _conv(cin: int, cout: int, kernel, bias: bool = True, stride: int = 1) -> nn.Conv2d:
    """Conv with the JAX package's ``_conv`` padding: (kh//2, kw//2)."""
    kh, kw = kernel if isinstance(kernel, tuple) else (kernel, kernel)
    return nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=(kh // 2, kw // 2),
                     bias=bias)


class SEModule(nn.Module):
    """det_mobilenet_v3.SEModule: pool -> 1x1 ReLU -> 1x1 hard sigmoid
    (slope 0.2) -> scale."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.conv1 = _conv(channels, channels // reduction, 1)
        self.conv2 = _conv(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = F.relu(self.conv1(x.mean(dim=(2, 3), keepdim=True)))
        return x * hard_sigmoid(self.conv2(att), 0.2)


class RSELayer(nn.Module):
    """Conv (no bias) + squeeze-excite, with a residual when ``shortcut``."""

    def __init__(self, cin: int, cout: int, kernel: int, shortcut: bool = True):
        super().__init__()
        self.in_conv = _conv(cin, cout, kernel, bias=False)
        self.se_block = SEModule(cout)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        se = self.se_block(x)
        return x + se if self.shortcut else se


class RSEFPN(nn.Module):
    """The mobile neck: 1x1 RSE laterals, top-down sums, 3x3 RSE per level,
    every level upsampled to stride 4 and concatenated (p5, p4, p3, p2)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 96,
                 shortcut: bool = True):
        super().__init__()
        q = out_channels // 4
        for i, c in enumerate(in_channels):
            self.add_module(f"ins_conv_{i}", RSELayer(c, out_channels, 1, shortcut))
            self.add_module(f"inp_conv_{i}", RSELayer(out_channels, q, 3, shortcut))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        m = self._modules
        in2, in3, in4, in5 = (m[f"ins_conv_{i}"](c) for i, c in enumerate(feats))
        out4 = in4 + upsample_nearest(in5, 2)
        out3 = in3 + upsample_nearest(out4, 2)
        out2 = in2 + upsample_nearest(out3, 2)
        p5 = m["inp_conv_3"](in5)
        p4 = m["inp_conv_2"](out4)
        p3 = m["inp_conv_1"](out3)
        p2 = m["inp_conv_0"](out2)
        return torch.cat([upsample_nearest(p5, 8), upsample_nearest(p4, 4),
                          upsample_nearest(p3, 2), p2], dim=1)


class IntraCLBlock(nn.Module):
    """Three cascaded kxk + kx1 + 1xk stages (k = 7, 5, 3) on a stream of
    half the channels (reduce_factor 2), then 1x1 back, BN, ReLU, residual."""

    def __init__(self, channels: int):
        super().__init__()
        rc = channels // 2
        self.conv1x1_reduce_channel = _conv(channels, rc, 1)
        for k in (7, 5, 3):
            self.add_module(f"c_layer_{k}x{k}", _conv(rc, rc, k))
            self.add_module(f"v_layer_{k}x1", _conv(rc, rc, (k, 1)))
            self.add_module(f"q_layer_1x{k}", _conv(rc, rc, (1, k)))
        self.conv1x1_return_channel = _conv(rc, channels, 1)
        self.bn = nn.BatchNorm2d(channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1x1_reduce_channel(x)
        for k in (7, 5, 3):
            h = (h + getattr(self, f"c_layer_{k}x{k}")(h)
                 + getattr(self, f"v_layer_{k}x1")(h)
                 + getattr(self, f"q_layer_1x{k}")(h))
        return x + F.relu(self.bn(self.conv1x1_return_channel(h)))


class LKPAN(nn.Module):
    """Top-down FPN, 9x9 per-level convs, bottom-up PAN with stride-2 3x3
    heads and 9x9 laterals, IntraCL blocks, then every level upsampled to
    stride 4 and concatenated (p5, p4, p3, p2)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        q = out_channels // 4
        for i, c in enumerate(in_channels):
            self.add_module(f"ins_conv_{i}", _conv(c, out_channels, 1, bias=False))
            self.add_module(f"inp_conv_{i}", _conv(out_channels, q, 9, bias=False))
            self.add_module(f"pan_lat_conv_{i}", _conv(q, q, 9, bias=False))
            self.add_module(f"incl{i + 1}", IntraCLBlock(q))
        for i in range(3):
            self.add_module(f"pan_head_conv_{i}", _conv(q, q, 3, bias=False, stride=2))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        m = self._modules
        in2, in3, in4, in5 = (m[f"ins_conv_{i}"](c) for i, c in enumerate(feats))
        out4 = in4 + upsample_nearest(in5, 2)
        out3 = in3 + upsample_nearest(out4, 2)
        out2 = in2 + upsample_nearest(out3, 2)
        f5 = m["inp_conv_3"](in5)
        f4 = m["inp_conv_2"](out4)
        f3 = m["inp_conv_1"](out3)
        f2 = m["inp_conv_0"](out2)
        pan3 = f3 + m["pan_head_conv_0"](f2)
        pan4 = f4 + m["pan_head_conv_1"](pan3)
        pan5 = f5 + m["pan_head_conv_2"](pan4)
        p2, p3, p4, p5 = (m[f"incl{i + 1}"](m[f"pan_lat_conv_{i}"](p))
                          for i, p in enumerate((f2, pan3, pan4, pan5)))
        return torch.cat([upsample_nearest(p5, 8), upsample_nearest(p4, 4),
                          upsample_nearest(p3, 2), p2], dim=1)
