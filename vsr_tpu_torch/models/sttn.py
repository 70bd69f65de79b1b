"""STTN spatio-temporal transformer inpainting generator (PyTorch).

Counterpart of ``vsr_tpu/models/sttn.py``: a 4-conv stride-4 encoder
(3->64->64->128->C, LeakyReLU 0.2), ``stack_num`` transformer blocks
(multi-scale patch attention + dilated-conv feed-forward, both residual) and
a decoder with two align-corners bilinear 2x upsamples and a tanh.

Submodules carry the reference checkpoint's names (``encoder.{0,2,4,6}``,
``transformer.{i}.attention.query_embedding``, ...,
``decoder.{0.conv,2,4.conv,6}``), so a reference ``netG`` state dict loads
with ``load_state_dict(strict=True)``.

Layouts at the public methods are those of the JAX package, so the two are
compared like with like: NHWC at ``encode``/``decode`` and [B, L, h, w, C]
at ``transform``. The convolutions run NCHW inside. The compute dtype is the
parameters' dtype (``model.to(torch.bfloat16)``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vsr_tpu_torch.ops.patch_attention import multi_scale_patch_attention
from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners

STTN_AUTO_PATCHSIZES: Tuple[Tuple[int, int], ...] = ((80, 15), (32, 6), (10, 5), (5, 3))
STTN_DET_PATCHSIZES: Tuple[Tuple[int, int], ...] = ((108, 60), (36, 20), (18, 10), (9, 5))

# Model input sizes (W, H) per variant.
STTN_AUTO_INPUT_SIZE = (640, 120)
STTN_DET_INPUT_SIZE = (432, 240)


def _lrelu() -> nn.Module:
    return nn.LeakyReLU(0.2)


class STTNEncoder(nn.Sequential):
    """Stride-4 conv encoder: [N, 3, H, W] -> [N, C, H/4, W/4]."""

    def __init__(self, channel: int = 256):
        super().__init__(
            nn.Conv2d(3, 64, 3, stride=2, padding=1), _lrelu(),
            nn.Conv2d(64, 64, 3, padding=1), _lrelu(),
            nn.Conv2d(64, 128, 3, stride=2, padding=1), _lrelu(),
            nn.Conv2d(128, channel, 3, padding=1), _lrelu(),
        )


class _Deconv(nn.Module):
    """Align-corners 2x upsample then a 3x3 conv (the reference's deconv)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_bilinear_2x_align_corners(x))


class STTNDecoder(nn.Sequential):
    """[N, C, h, w] -> [N, 3, 4h, 4w] in [-1, 1]."""

    def __init__(self, channel: int = 256):
        super().__init__(
            _Deconv(channel, 128), _lrelu(),
            nn.Conv2d(128, 64, 3, padding=1), _lrelu(),
            _Deconv(64, 64), _lrelu(),
            nn.Conv2d(64, 3, 3, padding=1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(x))


class _AttentionLayer(nn.Module):
    """q/k/v 1x1 embeddings + multi-scale patch attention + 3x3 output conv."""

    def __init__(self, patchsizes: Sequence[Tuple[int, int]], channel: int,
                 use_kernel: bool):
        super().__init__()
        self.patchsizes = tuple(patchsizes)
        self.use_kernel = use_kernel
        self.query_embedding = nn.Conv2d(channel, channel, 1)
        self.key_embedding = nn.Conv2d(channel, channel, 1)
        self.value_embedding = nn.Conv2d(channel, channel, 1)
        self.output_linear = nn.Sequential(
            nn.Conv2d(channel, channel, 3, padding=1), _lrelu())

    def forward(self, x: torch.Tensor, B: int, L: int,
                key_valid: Optional[torch.Tensor],
                patch_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: [B*L, C, h, w] -> [B*L, C, h, w]."""
        _, C, h, w = x.shape

        def grid(t):  # [B*L, C, h, w] -> [B, L, h, w, C] view
            return t.view(B, L, C, h, w).permute(0, 1, 3, 4, 2)

        y = multi_scale_patch_attention(
            grid(self.query_embedding(x)), grid(self.key_embedding(x)),
            grid(self.value_embedding(x)), self.patchsizes,
            key_valid=key_valid, patch_mask=patch_mask, use_kernel=self.use_kernel)
        y = y.permute(0, 1, 4, 2, 3).reshape(B * L, C, h, w)
        return self.output_linear(y)


class _FeedForward(nn.Module):
    """Dilated 3x3 conv + 3x3 conv, both LeakyReLU."""

    def __init__(self, channel: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(channel, channel, 3, padding=2, dilation=2), _lrelu(),
            nn.Conv2d(channel, channel, 3, padding=1), _lrelu())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class TransformerBlock(nn.Module):
    def __init__(self, patchsizes: Sequence[Tuple[int, int]], channel: int = 256,
                 use_kernel: bool = True):
        super().__init__()
        self.attention = _AttentionLayer(patchsizes, channel, use_kernel)
        self.feed_forward = _FeedForward(channel)

    def forward(self, x, B, L, key_valid=None, patch_mask=None):
        x = x + self.attention(x, B, L, key_valid, patch_mask)
        return x + self.feed_forward(x)


class STTNGenerator(nn.Module):
    """Generator with separately callable encode / transform / decode stages:
    encode a chunk's frames once, run the transformer per batch of windows
    over gathered features, decode only each window's neighbour outputs.

    ``apply_attention_mask`` (det variant only): False reproduces the
    reference's no-op hole mask in attention. ``use_kernel`` routes the
    small-patch scales through the token-attention kernel.
    """

    def __init__(self, variant: str = "auto", channel: int = 256, stack_num: int = 8,
                 apply_attention_mask: bool = True,
                 patchsizes_override: Optional[Tuple[Tuple[int, int], ...]] = None,
                 use_kernel: bool = True):
        super().__init__()
        if variant not in ("auto", "det"):
            raise ValueError(f"unknown STTN variant: {variant}")
        self.variant = variant
        self.apply_attention_mask = apply_attention_mask
        if patchsizes_override is not None:
            self.patchsizes = tuple(patchsizes_override)
        else:
            self.patchsizes = STTN_AUTO_PATCHSIZES if variant == "auto" else STTN_DET_PATCHSIZES
        self.encoder = STTNEncoder(channel)
        self.transformer = nn.ModuleList(
            TransformerBlock(self.patchsizes, channel, use_kernel)
            for _ in range(stack_num))
        self.decoder = STTNDecoder(channel)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder[0].weight.dtype

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] in [-1, 1] -> [N, h, w, C] features."""
        x = frames.to(self.dtype).permute(0, 3, 1, 2)
        return self.encoder(x).permute(0, 2, 3, 1)

    def transform(
        self,
        feats: torch.Tensor,                        # [B, L, h, w, C]
        key_valid: Optional[torch.Tensor] = None,   # [B, L] bool
        feat_mask: Optional[torch.Tensor] = None,   # [B, L, h, w] hole mask
    ) -> torch.Tensor:
        patch_mask = feat_mask if (self.variant == "det" and self.apply_attention_mask) else None
        B, L, h, w, C = feats.shape
        x = feats.to(self.dtype).permute(0, 1, 4, 2, 3).reshape(B * L, C, h, w)
        for block in self.transformer:
            x = block(x, B, L, key_valid, patch_mask)
        return x.view(B, L, C, h, w).permute(0, 1, 3, 4, 2)

    def decode(self, feats: torch.Tensor) -> torch.Tensor:
        """[N, h, w, C] -> [N, H, W, 3] in [-1, 1]."""
        x = feats.to(self.dtype).permute(0, 3, 1, 2)
        return self.decoder(x).permute(0, 2, 3, 1)
