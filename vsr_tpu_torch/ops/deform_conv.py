"""Modulated deformable convolution (DCNv2): counterpart of
``vsr_tpu/ops/deform_conv.py``.

The one op the reference takes from torchvision's C++/CUDA code
(modules/deformconv.py:7-54 -> torchvision.ops.deform_conv2d), used by
ProPainter's feature alignment and by the flow-completion network's
second-order alignment. A kh x kw modulated deformable conv is, for every
output position, group and tap, a bilinear sample of the input at
position + tap + offset (zeros outside the image), scaled by the tap's
modulation, then contracted with the weight. Here that is one gather per
bilinear corner over each group's flattened H*W axis (every channel of a
group at the same index) and one matmul; the JAX package's patch path
(one-hot contraction over a window around the flow) was a TPU workaround
for the cost of gathering rows there and is not carried.

Layout: x [B, C, H, W]; offset [B, G, K, 2, H, W] with (dy, dx) last
(torchvision's interleave: channel 2k of group g is dy of tap k); modulation
[B, G, K, H, W]; weight [Cout, C, kh, kw]. Group g owns the contiguous
channels [g*C/G, (g+1)*C/G). Taps run row-major over the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch


def modulated_deform_conv(
    x: torch.Tensor,
    offset: torch.Tensor,
    modulation: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stride-1, same-padding modulated deformable conv -> [B, Cout, H, W]."""
    B, C, H, W = x.shape
    cout, wc, kh, kw = weight.shape
    G, K = offset.shape[1], kh * kw
    assert offset.shape == (B, G, K, 2, H, W), offset.shape
    assert modulation.shape == (B, G, K, H, W), modulation.shape
    assert wc == C and C % G == 0
    cg, P = C // G, H * W
    dev, dtype = x.device, x.dtype

    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) - (kh - 1) // 2,
                            torch.arange(kw, device=dev) - (kw - 1) // 2, indexing="ij")
    # sample positions [B, G, K, H, W]
    off = offset.float()
    px = (xs + kx.reshape(K, 1, 1)).float() + off[:, :, :, 1]
    py = (ys + ky.reshape(K, 1, 1)).float() + off[:, :, :, 0]
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0

    feat = x.reshape(B * G, cg, P)
    mod = modulation.to(dtype)
    samples = None  # [B*G, cg, K*H*W]: channel (g, c), then tap, then position
    for dx, dy, w in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                      (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        xi, yi = x0 + dx, y0 + dy
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B * G, 1, K * P)
        corner = torch.gather(feat, 2, idx.expand(-1, cg, -1))
        term = corner * ((w * inb).to(dtype) * mod).reshape(B * G, 1, K * P)
        samples = term if samples is None else samples + term

    # [Cout, C*K] x [B, C*K, H*W]: the weight's own layout
    out = weight.reshape(cout, C * K).to(dtype) @ samples.reshape(B, C * K, P)
    out = out.reshape(B, cout, H, W)
    if bias is not None:
        out = out + bias.to(dtype)[:, None, None]
    return out
