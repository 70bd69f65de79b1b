"""I3D checkpoint conversion (i3d_rgb_imagenet.pt, the VFID metric's), in
numpy.

A copy of ``vsr_tpu/convert/torch_i3d.py`` without jax. The reference builds
``InceptionI3d(400, in_channels=3)`` and loads a plain state dict
(backend/inpaint/video/core/metrics.py:62-67). Its module paths follow the
Kinetics endpoint names (``Conv3d_1a_7x7``, ``Mixed_3b.b0`` ...); the JAX
package's flax tree (models/i3d.py) uses ``conv1a`` / ``mixed_3b/b0``, and
the torch ``b3b`` unit (the conv after the branch-3 pool) is flax ``b3``.
The logits head is a 1x1x1 conv in torch and a Dense in flax: squeezed on
conversion.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import as_leaf, convert_state_dict

_RULES: list = []
for torch_name, flax_name in (
    ("Conv3d_1a_7x7", "conv1a"),
    ("Conv3d_2b_1x1", "conv2b"),
    ("Conv3d_2c_3x3", "conv2c"),
):
    _RULES += [
        (rf"{torch_name}\.conv3d", f"{flax_name}/conv", "conv3d"),
        (rf"{torch_name}\.bn", f"{flax_name}/bn", "batchnorm"),
    ]
for branch_t, branch_f in (("b0", "b0"), ("b1a", "b1a"), ("b1b", "b1b"),
                           ("b2a", "b2a"), ("b2b", "b2b"), ("b3b", "b3")):
    _RULES += [
        (rf"Mixed_(\w+)\.{branch_t}\.conv3d", rf"mixed_\1/{branch_f}/conv", "conv3d"),
        (rf"Mixed_(\w+)\.{branch_t}\.bn", rf"mixed_\1/{branch_f}/bn", "batchnorm"),
    ]


def convert_i3d_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    rest = {}
    logits_w = logits_b = None
    for k, v in state_dict.items():
        if k == "logits.conv3d.weight":
            logits_w = as_leaf(v)  # [400, 1024, 1, 1, 1]
        elif k == "logits.conv3d.bias":
            logits_b = as_leaf(v)
        else:
            rest[k] = v
    out = convert_state_dict(rest, _RULES)
    if logits_w is not None:
        out["params"]["logits"] = {
            "kernel": as_leaf(logits_w.reshape(logits_w.shape[0], -1).T),
            "bias": logits_b,
        }
    return out


def load_i3d_checkpoint(path: str) -> Dict[str, Any]:
    import torch

    return convert_i3d_state_dict(torch.load(path, map_location="cpu"))
