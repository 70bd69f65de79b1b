"""LaMa (big-lama) fast-Fourier-convolution inpainting generator (PyTorch).

Counterpart of ``vsr_tpu/models/lama.py``: the big-lama hyper-parameters
(ngf 64, 3 downsamples to 512 channels, 18 FFC residual blocks with global
ratio 0.75), a spectral transform with ortho-normalized rfft2, a sigmoid
output. Modules carry the flax names (``stem``, ``down{i}``,
``block{b}.conv1.ffc.g2g.fu.conv``, ``up{i}``, ``head``), so the JAX
package's variables load through ``convert.from_flax.lama_state_dict_from_flax``
by name.

Contract, as in the JAX package: image [B, H, W, 3] in [0, 1] and mask
[B, H, W, 1] in {0, 1}, H and W multiples of 8, NHWC in and out; the net
sees concat(image * (1 - mask), mask) and returns the whole inpainted image
in [0, 1]. NCHW inside. The model computes in the dtype of its parameters;
the FFTs run in fp32 (cuFFT has no bf16 transform), with explicit casts
around them. The JAX package's DFT-matmul FFTs and their ``fft_impl``
option were a TPU workaround and are not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5)


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class FourierUnit(nn.Module):
    """rfft2 -> channel-major (re, im) interleave -> 1x1 conv, BN, ReLU ->
    irfft2. Spectral channel 2c holds the real part of channel c and 2c + 1
    its imaginary part (the flax reshape of the stacked pair, and
    big-lama's stack + view), which the converted 1x1 weights rely on."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(2 * cin, 2 * cout, 1, bias=False)
        self.bn = _bn(2 * cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        dtype = x.dtype
        f = torch.fft.rfft2(x.float(), norm="ortho")  # [B, C, H, W//2+1]
        z = torch.stack([f.real, f.imag], dim=2).reshape(B, 2 * C, H, W // 2 + 1)
        z = F.relu(self.bn(self.conv(z.to(dtype))))
        z = z.float().reshape(B, -1, 2, H, W // 2 + 1)
        out = torch.fft.irfft2(torch.complex(z[:, :, 0], z[:, :, 1]), s=(H, W), norm="ortho")
        return out.to(dtype)


class SpectralTransform(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = cout // 2
        self.conv1 = nn.Conv2d(cin, half, 1, bias=False)
        self.bn1 = _bn(half)
        self.fu = FourierUnit(half, half)
        self.conv2 = nn.Conv2d(half, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return self.conv2(x + self.fu(x))


class FFC(nn.Module):
    """Fast Fourier convolution over a (local, global) channel split: l2l,
    g2l and l2g are 3x3 convs on a reflect-padded input (big-lama's
    padding_mode='reflect'), g2g the spectral transform. A path whose input
    or output has no channels does not exist."""

    def __init__(self, in_l: int, in_g: int, out_l: int, out_g: int, stride: int = 1):
        super().__init__()

        def conv(cin, cout):
            return nn.Conv2d(cin, cout, 3, stride=stride, bias=False)

        self.l2l = conv(in_l, out_l) if out_l else None
        self.g2l = conv(in_g, out_l) if in_g and out_l else None
        self.l2g = conv(in_l, out_g) if out_g else None
        self.g2g = SpectralTransform(in_g, out_g) if in_g and out_g else None

    def forward(self, x_l: torch.Tensor, x_g: Optional[torch.Tensor]):
        pad_l = _reflect_pad(x_l, 1)
        yl = self.l2l(pad_l) if self.l2l is not None else None
        if self.g2l is not None:
            yl = yl + self.g2l(_reflect_pad(x_g, 1))
        yg = None
        if self.l2g is not None:
            yg = self.l2g(pad_l)
            if self.g2g is not None:
                yg = yg + self.g2g(x_g)
        return yl, yg


class FFCBnAct(nn.Module):
    def __init__(self, in_l: int, in_g: int, out_l: int, out_g: int, stride: int = 1):
        super().__init__()
        self.ffc = FFC(in_l, in_g, out_l, out_g, stride)
        self.bn_l = _bn(out_l) if out_l else None
        self.bn_g = _bn(out_g) if out_g else None

    def forward(self, x_l, x_g):
        yl, yg = self.ffc(x_l, x_g)
        if yl is not None:
            yl = F.relu(self.bn_l(yl))
        if yg is not None:
            yg = F.relu(self.bn_g(yg))
        return yl, yg


class FFCResnetBlock(nn.Module):
    def __init__(self, features: int, ratio: float = 0.75):
        super().__init__()
        g = int(features * ratio)
        l = features - g
        self.conv1 = FFCBnAct(l, g, l, g)
        self.conv2 = FFCBnAct(l, g, l, g)

    def forward(self, x_l, x_g):
        y_l, y_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + y_l, x_g + y_g


class LamaGenerator(nn.Module):
    def __init__(self, ngf: int = 64, n_downsampling: int = 3, n_blocks: int = 18,
                 global_ratio: float = 0.75):
        super().__init__()
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        self.stem = nn.Conv2d(4, ngf, 7, bias=False)
        self.stem_bn = _bn(ngf)
        feats = ngf
        for i in range(n_downsampling):
            out = min(feats * 2, ngf * 8)
            out_g = int(out * global_ratio) if i == n_downsampling - 1 else 0
            self.add_module(f"down{i}", FFCBnAct(feats, 0, out - out_g, out_g, stride=2))
            feats = out
        for b in range(n_blocks):
            self.add_module(f"block{b}", FFCResnetBlock(feats, global_ratio))
        for i in range(n_downsampling):
            # torch ConvTranspose2d(k3, s2, p1, output_padding=1) == the flax
            # ConvTranspose with ((1, 2), (1, 2)) padding and
            # transpose_kernel=True; bias on, then BN, as in big-lama
            self.add_module(f"up{i}", nn.ConvTranspose2d(
                feats, feats // 2, 3, stride=2, padding=1, output_padding=1))
            self.add_module(f"up{i}_bn", _bn(feats // 2))
            feats //= 2
        self.head = nn.Conv2d(ngf, 3, 7)

    def forward(self, image: torch.Tensor, mask: torch.Tensor,
                out_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """image [B, H, W, 3] in [0, 1]; mask [B, H, W, 1] in {0, 1} ->
        [B, H, W, 3] in [0, 1], fp32.

        out_rows=(r0, out_h): return only rows [r0, r0 + out_h) (out_h
        even). The trunk still sees every row (the spectral transform is
        global), but the upsampling tail runs only on the half-resolution
        rows those output rows need plus an 8-row margin on each side, which
        covers the transpose convs' and the head's reflect padding's edge
        effects; where the clamp binds, the slice's edge is the image's.
        The rows equal those of the full forward (vsr_tpu's out_rows)."""
        dtype = self.stem.weight.dtype
        x = torch.cat([image * (1.0 - mask), mask], dim=-1).to(dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem(_reflect_pad(x, 3))))

        x_l, x_g = x, None
        for i in range(self.n_downsampling):
            x_l, x_g = getattr(self, f"down{i}")(x_l, x_g)
        for b in range(self.n_blocks):
            x_l, x_g = getattr(self, f"block{b}")(x_l, x_g)
        x = torch.cat([x_l, x_g], dim=1)

        row_off = None
        for i in range(self.n_downsampling):
            if out_rows is not None and i == self.n_downsampling - 1:
                r0, out_h = out_rows
                if out_h % 2:
                    raise ValueError(f"out_rows height must be even, got {out_h}")
                h_half = x.shape[2]
                slice_h = min(h_half, out_h // 2 + 8)
                s0 = min(max(r0 // 2 - 4, 0), h_half - slice_h)
                x = x[:, :, s0:s0 + slice_h]
                row_off = r0 - 2 * s0
            x = getattr(self, f"up{i}")(x)
            x = F.relu(getattr(self, f"up{i}_bn")(x))

        x = self.head(_reflect_pad(x, 3))
        out = torch.sigmoid(x.float())
        if row_off is not None:
            out = out[:, :, row_off:row_off + out_rows[1]]
        return out.permute(0, 2, 3, 1)
