"""VGG feature extractor for perceptual losses: counterpart of
``vsr_tpu/models/vgg.py`` (the reference's VGGFeatureExtractor,
backend/inpaint/video/model/vgg_arch.py:51-157).

A torchvision VGG ``features`` trunk cut after the deepest requested layer,
returning the named activations (conv1_1 ... pool5), with optional
[-1, 1] -> [0, 1] range normalisation and ImageNet input normalisation.
Images are [B, 3, H, W]; features [B, C, h, w]. The convolutions carry the
layer names (``conv3_2``), so the JAX package's params load through
``convert.from_flax.vgg_state_dict_from_flax``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Layer-name sequences per VGG flavour (vgg_arch.py NAMES table).
VGG_NAMES = {
    "vgg16": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
        "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3",
        "pool3",
        "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3",
        "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
        "pool5",
    ],
    "vgg19": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
        "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3",
        "conv3_4", "relu3_4", "pool3",
        "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3",
        "conv4_4", "relu4_4", "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
        "conv5_4", "relu5_4", "pool5",
    ],
}

WIDTH = {"1": 64, "2": 128, "3": 256, "4": 512, "5": 512}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def channel_constant(values, x: torch.Tensor) -> torch.Tensor:
    """A per-channel constant as [1, C, 1, 1] in x's dtype and device."""
    return torch.tensor(values, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)


class VGGFeatures(nn.Module):
    """Truncated VGG trunk returning the requested named activations."""

    def __init__(self, layers: Sequence[str], vgg_type: str = "vgg19",
                 use_input_norm: bool = True, range_norm: bool = False):
        super().__init__()
        names = VGG_NAMES[vgg_type]
        unknown = [name for name in layers if name not in names]
        if unknown:
            raise ValueError(f"{unknown} are not layers of {vgg_type}")
        self.layers = tuple(layers)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        self.names = names[: max(names.index(name) for name in layers) + 1]
        cin = 3
        for name in self.names:
            if name.startswith("conv"):
                self.add_module(name, nn.Conv2d(cin, WIDTH[name[4]], 3, padding=1))
                cin = WIDTH[name[4]]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - channel_constant(IMAGENET_MEAN, x)) / channel_constant(IMAGENET_STD, x)
        out: Dict[str, torch.Tensor] = {}
        for name in self.names:
            if name.startswith("conv"):
                x = getattr(self, name)(x)
            elif name.startswith("relu"):
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
            if name in self.layers:
                out[name] = x
        return out
