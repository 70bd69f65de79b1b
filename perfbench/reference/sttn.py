"""Plain reference of the STTN InpaintGenerator (researchmm/STTN, Zeng et al.,
ECCV 2020, ``model/sttn.py``) as the video-subtitle-remover runs it.

Written from the published model, in its own layout (NCHW, the upstream
token order d_k x height x width), in float32 with plain convolutions,
matmuls and softmax. Module names follow the upstream ``netG`` state dict,
so the benchmark's seeded state dict loads strictly.

``quant`` is applied to both operands of every convolution and matmul. The
reference passes them through unchanged; the control (``fp8_e4m3``) rounds
each to float8 e4m3 with a per-tensor scale, the precision below the bf16
that the configurations state.

Departures from the upstream file, each a choice the subtitle remover's STTN
modes make: ``infer`` takes an optional hole mask at image scale (the det
mode's attention mask; the auto mode passes none), and a key patch whose
mean mask is over 0.5 is masked with -1e9 as upstream does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Quant = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under a per-tensor scale (amax to 448), back in
    float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


QUANTS = {"float32": identity, "fp8_e4m3": fp8_e4m3}


def conv(layer: nn.Conv2d, x: torch.Tensor, q: Quant) -> torch.Tensor:
    return F.conv2d(q(x), q(layer.weight), layer.bias, layer.stride, layer.padding,
                    layer.dilation)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Deconv(nn.Module):
    """Bilinear 2x upsample (align_corners=True), then a 3x3 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x, q):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return conv(self.conv, x, q)


class MultiHeadedAttention(nn.Module):
    def __init__(self, patchsize: Sequence[Tuple[int, int]], d_model: int):
        super().__init__()
        self.patchsize = [tuple(p) for p in patchsize]
        self.query_embedding = nn.Conv2d(d_model, d_model, 1)
        self.value_embedding = nn.Conv2d(d_model, d_model, 1)
        self.key_embedding = nn.Conv2d(d_model, d_model, 1)
        self.output_linear = nn.Sequential(nn.Conv2d(d_model, d_model, 3, padding=1),
                                           nn.LeakyReLU(0.2))

    def forward(self, x, m, b, q):
        """x [b*t, c, h, w]; m: [b*t, 1, h, w] hole mask at feature scale or None."""
        bt, c, h, w = x.shape
        t = bt // b
        d_k = c // len(self.patchsize)
        outs = []
        chunks = [torch.chunk(conv(e, x, q), len(self.patchsize), dim=1)
                  for e in (self.query_embedding, self.key_embedding, self.value_embedding)]
        for s, (width, height) in enumerate(self.patchsize):
            query, key, value = (ch[s] for ch in chunks)
            out_w, out_h = w // width, h // height

            def tokens(z, dim):
                z = z.reshape(b, t, dim, out_h, height, out_w, width)
                return z.permute(0, 1, 3, 5, 2, 4, 6).reshape(
                    b, t * out_h * out_w, dim * height * width)

            query, key, value = tokens(query, d_k), tokens(key, d_k), tokens(value, d_k)
            scores = torch.matmul(q(query), q(key).transpose(-2, -1)) / math.sqrt(
                query.shape[-1])
            if m is not None:
                hole = tokens(m, 1).mean(-1) > 0.5  # [b, n] key patches mostly hole
                scores = scores.masked_fill(hole[:, None, :], -1e9)
            p = F.softmax(scores, dim=-1)
            y = torch.matmul(q(p), q(value))
            y = y.reshape(b, t, out_h, out_w, d_k, height, width)
            outs.append(y.permute(0, 1, 4, 2, 5, 3, 6).reshape(bt, d_k, h, w))
        return lrelu(conv(self.output_linear[0], torch.cat(outs, 1), q))


class FeedForward(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(d_model, d_model, 3, padding=2, dilation=2), nn.LeakyReLU(0.2),
            nn.Conv2d(d_model, d_model, 3, padding=1), nn.LeakyReLU(0.2))

    def forward(self, x, q):
        return lrelu(conv(self.conv[2], lrelu(conv(self.conv[0], x, q)), q))


class TransformerBlock(nn.Module):
    def __init__(self, patchsize, hidden: int):
        super().__init__()
        self.attention = MultiHeadedAttention(patchsize, hidden)
        self.feed_forward = FeedForward(hidden)

    def forward(self, x, m, b, q):
        x = x + self.attention(x, m, b, q)
        return x + self.feed_forward(x, q)


class InpaintGenerator(nn.Module):
    def __init__(self, channel: int, stack_num: int,
                 patchsize: Sequence[Tuple[int, int]], quant: str = "float32"):
        super().__init__()
        self.q = QUANTS[quant]
        self.encoder = nn.Sequential(
            nn.Conv2d(3, 64, 3, stride=2, padding=1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 64, 3, stride=1, padding=1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 128, 3, stride=2, padding=1), nn.LeakyReLU(0.2),
            nn.Conv2d(128, channel, 3, stride=1, padding=1), nn.LeakyReLU(0.2))
        self.transformer = nn.Sequential(
            *[TransformerBlock(patchsize, channel) for _ in range(stack_num)])
        self.decoder = nn.Sequential(
            Deconv(channel, 128), nn.LeakyReLU(0.2),
            nn.Conv2d(128, 64, 3, stride=1, padding=1), nn.LeakyReLU(0.2),
            Deconv(64, 64), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 3, 3, stride=1, padding=1))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [t, 3, H, W] in [-1, 1] -> features [t, c, H/4, W/4]."""
        x = frames
        for i in (0, 2, 4, 6):
            x = lrelu(conv(self.encoder[i], x, self.q))
        return x

    def infer(self, feat: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One window's features [t, c, h, w] through the blocks; masks
        [t, 1, H, W] at image scale (det), nearest-downscaled by 4."""
        m = None if masks is None else F.interpolate(masks, scale_factor=0.25)
        x = feat
        for block in self.transformer:
            x = block(x, m, 1, self.q)
        return x

    def decode_logits(self, feat: torch.Tensor) -> torch.Tensor:
        """[n, c, h, w] -> [n, 3, 4h, 4w], before the tanh."""
        d = self.decoder
        x = lrelu(d[0](feat, self.q))
        x = lrelu(conv(d[2], x, self.q))
        x = lrelu(d[4](x, self.q))
        return conv(d[6], x, self.q)

    def decode(self, feat: torch.Tensor) -> torch.Tensor:
        """[n, c, h, w] -> [n, 3, 4h, 4w] in [-1, 1]."""
        return torch.tanh(self.decode_logits(feat))
