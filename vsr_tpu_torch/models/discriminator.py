"""Spatio-temporal video discriminator for GAN training: counterpart of
``vsr_tpu/models/discriminator.py`` (the reference's Discriminator,
backend/inpaint/sttn/auto_sttn.py:246-288).

Six Conv3d layers with kernel (3, 5, 5) and stride (1, 2, 2), LeakyReLU 0.2
after all but the last, spectral norm on all but the last (which alone has a
bias), an optional sigmoid. Videos are [B, T, C, H, W], as the port's
ProPainter takes them; the convolutions see [B, C, T, H, W].

Spectral norm follows flax's ``nn.SpectralNorm`` (flax 0.12.3
``_spectral_normalize``), not torch's parametrization: every call runs one
power-iteration step from the stored ``u`` on the kernel viewed as a
[K, Cout] matrix, with ``x * rsqrt(sum(x^2) + 1e-12)`` normalisation, u and v
detached (sigma keeps its gradient through W), and stores u and sigma only
when ``update_stats=True``. ``torch.nn.utils.parametrizations.spectral_norm``
stores u on every train-mode call and skips the iteration in eval mode, so it
would differ from the JAX package on the fake and generator passes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_K = (3, 5, 5)
_S = (1, 2, 2)
_PAD1 = (1, 1, 1)
_PAD2 = (1, 2, 2)
_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + _EPS)


class SpectralNormConv3d(nn.Module):
    """A bias-free Conv3d whose kernel is divided by its largest singular
    value, estimated by one power-iteration step a call. Buffers: ``u``
    [1, Cout] (the power iteration's state) and ``sigma`` (the last stored
    estimate), flax's ``batch_stats``."""

    def __init__(self, cin: int, cout: int, padding, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding = padding
        fan_in = cin * _K[0] * _K[1] * _K[2]  # LeCun normal, flax's default
        self.weight = nn.Parameter(torch.randn((cout, cin, *_K), generator=generator)
                                   / fan_in ** 0.5)
        self.register_buffer("u", torch.randn((1, cout), generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight
        # the rows of flax's [kt*kh*kw*Cin, Cout] view, in another order:
        # sums over them, hence sigma, do not depend on it
        mat = w.reshape(w.shape[0], -1)  # [Cout, K]
        with torch.no_grad():
            v = _l2_normalize(self.u.to(w.dtype) @ mat)  # [1, K]
            u = _l2_normalize(v @ mat.t())               # [1, Cout]
        sigma = (v @ mat.t() @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return F.conv3d(x, self.normalized_weight(update_stats), None, _S, self.padding)


class VideoDiscriminator(nn.Module):
    """[B, T, 3, H, W] in [-1, 1] -> [B, T', nf*4, h', w'] features.

    ``conv0``..``conv4`` carry the flax names (spectral-norm convs without
    bias); ``conv5`` is a plain Conv3d with bias. ``seed`` draws the spectral-norm
    kernels and their initial u; the trainers then start every parameter as
    flax does (``inpaint.weights.init_random_``)."""

    def __init__(self, nf: int = 64, use_sigmoid: bool = False, seed: int = 0):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        gen = torch.Generator().manual_seed(seed)
        widths = [nf, nf * 2, nf * 4, nf * 4, nf * 4]
        pads = [_PAD1, _PAD2, _PAD2, _PAD2, _PAD2]
        cin = 3
        for i, (width, pad) in enumerate(zip(widths, pads)):
            self.add_module(f"conv{i}", SpectralNormConv3d(cin, width, pad, gen))
            cin = width
        self.conv5 = nn.Conv3d(cin, nf * 4, _K, _S, _PAD2)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        x = x.transpose(1, 2)  # [B, C, T, H, W]
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x, update_stats), 0.2)
        x = self.conv5(x)
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        return x.transpose(1, 2)
