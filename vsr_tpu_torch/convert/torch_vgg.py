"""torchvision VGG checkpoint -> VGGFeatures params, in numpy.

A copy of ``vsr_tpu/convert/torch_vgg.py`` without jax. torchvision's
``vgg16`` / ``vgg19`` store the trunk as ``features.{i}``, where ``i``
enumerates conv / relu / pool modules in order: exactly the order of
models.vgg.VGG_NAMES (the reference zips the two in vgg_arch.py:108-119).
Keys outside ``features.*`` (``classifier.*``) are dropped: perceptual losses
never use them.

Used for the reference PerceptualLoss trunk (loss.py:42-46) and, through
convert/torch_lpips.py's names, the LPIPS vgg16 backbone.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import convert_state_dict
from vsr_tpu_torch.models.vgg import VGG_NAMES


def convert_vgg_state_dict(state_dict: Mapping[str, Any], vgg_type: str = "vgg19",
                           prefix: str = "features") -> Dict[str, Any]:
    rules = [(re.escape(prefix) + rf"\.{i}", name, "conv2d")
             for i, name in enumerate(VGG_NAMES[vgg_type]) if name.startswith("conv")]
    trunk_only = {k: v for k, v in state_dict.items() if k.startswith(f"{prefix}.")}
    return convert_state_dict(trunk_only, rules)


def load_vgg_checkpoint(path: str, vgg_type: str = "vgg19") -> Dict[str, Any]:
    import torch

    return convert_vgg_state_dict(torch.load(path, map_location="cpu"), vgg_type)
