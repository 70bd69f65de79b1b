"""Convert reference STTN torch checkpoints to flax-layout params (numpy).

A copy of ``vsr_tpu/convert/torch_sttn.py`` without jax. Checkpoint
layouts (ref):
* auto: ``torch.load('sttn-auto/infer_model.pth')['netG']``
* det:  ``torch.load('sttn-det/sttn.pth')['netG']`` (same nesting)

Key mapping (torch module path -> flax param path):
  encoder.{0,2,4,6}                         -> encoder/conv{0..3}
  transformer.{i}.attention.query_embedding -> block{i}/attention/query
  transformer.{i}.attention.key_embedding   -> block{i}/attention/key
  transformer.{i}.attention.value_embedding -> block{i}/attention/value
  transformer.{i}.attention.output_linear.0 -> block{i}/attention/out
  transformer.{i}.feed_forward.conv.{0,2}   -> block{i}/ffn/conv{0,1}
  decoder.0.conv / decoder.2 / decoder.4.conv / decoder.6
                                            -> decoder/{deconv0,conv1,deconv1,conv2}

Conv kernels transpose OIHW -> HWIO. ``convert/from_flax.py`` inverts these
tables.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import as_leaf, unflatten_tree

ENCODER = {f"encoder.{i * 2}": f"encoder/conv{i}" for i in range(4)}
DECODER = {
    "decoder.0.conv": "decoder/deconv0",
    "decoder.2": "decoder/conv1",
    "decoder.4.conv": "decoder/deconv1",
    "decoder.6": "decoder/conv2",
}
ATTN = {
    "query_embedding": "query",
    "key_embedding": "key",
    "value_embedding": "value",
    "output_linear.0": "out",
}


def _map_module(torch_path: str) -> str:
    if torch_path in ENCODER:
        return ENCODER[torch_path]
    if torch_path in DECODER:
        return DECODER[torch_path]
    m = re.fullmatch(r"transformer\.(\d+)\.attention\.(.+)", torch_path)
    if m and m.group(2) in ATTN:
        return f"block{m.group(1)}/attention/{ATTN[m.group(2)]}"
    m = re.fullmatch(r"transformer\.(\d+)\.feed_forward\.conv\.([02])", torch_path)
    if m:
        return f"block{m.group(1)}/ffn/conv{int(m.group(2)) // 2}"
    raise KeyError(f"unrecognized STTN checkpoint module: {torch_path}")


def convert_sttn_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """torch state dict (tensor or ndarray values) -> {'params': ...}."""
    flat = {}
    for key, value in state_dict.items():
        if not (key.endswith(".weight") or key.endswith(".bias")):
            continue
        module_path, kind = key.rsplit(".", 1)
        arr = as_leaf(value)
        flax_module = _map_module(module_path)
        if kind == "weight":
            flat[f"{flax_module}/kernel"] = arr.transpose(2, 3, 1, 0)
        else:
            flat[f"{flax_module}/bias"] = arr
    return {"params": unflatten_tree(flat)}


def load_sttn_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference .pth checkpoint and convert."""
    import torch

    ckpt = torch.load(path, map_location="cpu")
    state_dict = ckpt.get("netG", ckpt)
    return convert_sttn_state_dict(state_dict)
