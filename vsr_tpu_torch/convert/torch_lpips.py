"""lpips-package checkpoint -> LPIPS params, in numpy.

A copy of ``vsr_tpu/convert/torch_lpips.py`` without jax. The lpips package
serialises ``net.slice{k}.{i}.*`` (the vgg16 trunk in five Sequential slices
that keep torchvision's global ``features`` indices), the 1x1 heads
``lin{k}.model.1.weight`` (model.0 is Dropout) and the
``scaling_layer.shift`` / ``scale`` buffers, which are dropped (constants in
models/lpips.py). Reference usage: lpips.LPIPS(net='vgg') in
backend/inpaint/video/core/loss.py:122.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import convert_state_dict
from vsr_tpu_torch.models.vgg import VGG_NAMES


def convert_lpips_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    rules = [(rf"net\.slice\d\.{i}", f"net/{name}", "conv2d")
             for i, name in enumerate(VGG_NAMES["vgg16"]) if name.startswith("conv")]
    rules += [(rf"lin{k}\.model\.1", f"lin{k}", "conv2d") for k in range(5)]
    filtered = {k: v for k, v in state_dict.items() if not k.startswith("scaling_layer.")}
    return convert_state_dict(filtered, rules)


def load_lpips_checkpoint(path: str) -> Dict[str, Any]:
    import torch

    return convert_lpips_state_dict(torch.load(path, map_location="cpu"))
