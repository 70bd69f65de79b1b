"""LPIPS perceptual metric (vgg16 backbone): counterpart of
``vsr_tpu/models/lpips.py``, i.e. ``lpips.LPIPS(net='vgg', spatial=False)``
as the reference's LPIPSLoss uses it (backend/inpaint/video/core/
loss.py:116-144):

  scaling layer (shift / scale over [-1, 1] input)
  -> vgg16 activations at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3
  -> unit-normalise each activation over channels (eps 1e-10)
  -> squared difference -> per-layer 1x1 bias-free conv head (``lin{i}``)
  -> spatial mean -> sum over layers.

Images are [B, 3, H, W]. Modules carry the flax names (``net.conv1_1``,
``lin0``) for ``convert.from_flax.lpips_state_dict_from_flax``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vsr_tpu_torch.models.vgg import WIDTH, VGGFeatures, channel_constant

LPIPS_LAYERS: Tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")
# lpips.ScalingLayer buffers (the package pins these constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance between two [B, 3, H, W] images in [-1, 1] -> [B]."""

    def __init__(self):
        super().__init__()
        self.net = VGGFeatures(LPIPS_LAYERS, vgg_type="vgg16", use_input_norm=False)
        for i, layer in enumerate(LPIPS_LAYERS):
            self.add_module(f"lin{i}", nn.Conv2d(WIDTH[layer[4]], 1, 1, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale = channel_constant(_SHIFT, x), channel_constant(_SCALE, x)
        fx = self.net((x - shift) / scale)
        fy = self.net((y - shift) / scale)
        total = 0.0
        for i, layer in enumerate(LPIPS_LAYERS):
            d = _unit_normalize(fx[layer]) - _unit_normalize(fy[layer])
            total = total + getattr(self, f"lin{i}")(d * d).mean(dim=(1, 2, 3))
        return total
