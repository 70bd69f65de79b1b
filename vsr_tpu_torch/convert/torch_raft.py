"""RAFT checkpoint conversion (raft-things.pth), in numpy.

A copy of ``vsr_tpu/convert/torch_raft.py`` without jax. The reference loads
the checkpoint into a DataParallel wrapper so keys carry a ``module.``
prefix (flow_comp_raft.py:18-20). Encoder layer indexing: torch
layer{1,2,3}.{0,1} flatten to layer0..layer5; instance norms carry no
parameters (affine=False) and are skipped; cnet batch norms map into
params+batch_stats.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import convert_state_dict

_ENC_RULES = []
for net in ("fnet", "cnet"):
    _ENC_RULES += [
        (rf"{net}\.conv1", f"{net}/conv1", "conv2d"),
        (rf"{net}\.conv2", f"{net}/conv2", "conv2d"),
        (rf"{net}\.norm1", f"{net}/norm1/bn", "batchnorm"),
    ]
    for torch_layer in (1, 2, 3):
        for block in (0, 1):
            flax_idx = (torch_layer - 1) * 2 + block
            base = rf"{net}\.layer{torch_layer}\.{block}"
            flax = f"{net}/layer{flax_idx}"
            _ENC_RULES += [
                (base + r"\.conv1", f"{flax}/conv1", "conv2d"),
                (base + r"\.conv2", f"{flax}/conv2", "conv2d"),
                (base + r"\.norm1", f"{flax}/norm1/bn", "batchnorm"),
                (base + r"\.norm2", f"{flax}/norm2/bn", "batchnorm"),
                (base + r"\.norm3", f"{flax}/norm3/bn", "batchnorm"),
                (base + r"\.downsample\.0", f"{flax}/down", "conv2d"),
                (base + r"\.downsample\.1", f"{flax}/norm3/bn", "batchnorm"),
            ]

_UPDATE = r"update_block"
_RULES: list = _ENC_RULES + [
    (_UPDATE + r"\.encoder\.convc1", "step/update/encoder/convc1", "conv2d"),
    (_UPDATE + r"\.encoder\.convc2", "step/update/encoder/convc2", "conv2d"),
    (_UPDATE + r"\.encoder\.convf1", "step/update/encoder/convf1", "conv2d"),
    (_UPDATE + r"\.encoder\.convf2", "step/update/encoder/convf2", "conv2d"),
    (_UPDATE + r"\.encoder\.conv", "step/update/encoder/conv", "conv2d"),
    (_UPDATE + r"\.gru\.(conv[zrq][12])", r"step/update/gru/\1", "conv2d"),
    (_UPDATE + r"\.flow_head\.conv1", "step/update/flow1", "conv2d"),
    (_UPDATE + r"\.flow_head\.conv2", "step/update/flow2", "conv2d"),
    (_UPDATE + r"\.mask\.0", "step/update/mask1", "conv2d"),
    (_UPDATE + r"\.mask\.2", "step/update/mask2", "conv2d"),
]


def convert_raft_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    stripped = {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }
    return convert_state_dict(stripped, _RULES)


def load_raft_checkpoint(path: str) -> Dict[str, Any]:
    import torch

    return convert_raft_state_dict(torch.load(path, map_location="cpu"))
