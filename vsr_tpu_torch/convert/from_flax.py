"""JAX-package params -> the port's state dicts.

STTN: inverts the key map of ``vsr_tpu/convert/torch_sttn.py`` (copied here:
that module imports jax) and transposes conv kernels HWIO -> OIHW.
DBNet: the port's detector modules carry the flax names, so the map is
structural (see dbnet_state_dict_from_flax).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_ENCODER = {f"encoder/conv{i}": f"encoder.{i * 2}" for i in range(4)}
_DECODER = {
    "decoder/deconv0": "decoder.0.conv",
    "decoder/conv1": "decoder.2",
    "decoder/deconv1": "decoder.4.conv",
    "decoder/conv2": "decoder.6",
}
_ATTN = {
    "query": "query_embedding",
    "key": "key_embedding",
    "value": "value_embedding",
    "out": "output_linear.0",
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _map_module(flax_path: str) -> str:
    if flax_path in _ENCODER:
        return _ENCODER[flax_path]
    if flax_path in _DECODER:
        return _DECODER[flax_path]
    m = re.fullmatch(r"block(\d+)/attention/(\w+)", flax_path)
    if m and m.group(2) in _ATTN:
        return f"transformer.{m.group(1)}.attention.{_ATTN[m.group(2)]}"
    m = re.fullmatch(r"block(\d+)/ffn/conv([01])", flax_path)
    if m:
        return f"transformer.{m.group(1)}.feed_forward.conv.{int(m.group(2)) * 2}"
    raise KeyError(f"unrecognized STTN param module: {flax_path}")


def sttn_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax STTN params (the '/'-joined flat dict that
    ``vsr_tpu.convert.params_io.save_params`` writes to .npz, or the nested
    dict, with or without the top-level 'params') -> torch state dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(flat).items():
        if path.startswith("params/"):
            path = path[len("params/"):]
        module, kind = path.rsplit("/", 1)
        arr = np.asarray(value, dtype=np.float32)
        name = _map_module(module)
        if kind == "kernel":
            state[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif kind == "bias":
            state[f"{name}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unrecognized STTN param: {path}")
    return state


# flax leaf -> torch entry, per variable collection
_DBNET_LEAVES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def dbnet_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax DBNet variables (the '/'-joined flat dict that
    ``vsr_tpu.convert.params_io.save_params`` writes, or the nested dict with
    'params' and 'batch_stats') -> the port's DBNet state dict.

    Module paths map by name ('/' -> '.'). Conv kernels HWIO -> OIHW; a
    ``nn.ConvTranspose(transpose_kernel=True)`` kernel (kh, kw, O, I) ->
    ConvTranspose2d (I, O, kh, kw), the same axis permutation (the inverse
    of vsr_tpu/convert/mapping.py's convtranspose2d rule). BatchNorm scale,
    bias, mean and var -> weight, bias, running_mean, running_var (both use
    eps 1e-5). The training-only ``head/thresh`` branch is dropped: the
    port's head has no such branch. Any other unknown key raises.
    """
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(flat).items():
        collection, rest = path.split("/", 1)
        if collection not in _DBNET_LEAVES:
            raise KeyError(f"unrecognized DBNet variable collection: {path}")
        module, leaf = rest.rsplit("/", 1)
        if module.startswith("head/thresh/"):
            continue
        if leaf not in _DBNET_LEAVES[collection]:
            raise KeyError(f"unrecognized DBNet param: {path}")
        arr = np.array(value, dtype=np.float32)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        name = module.replace("/", ".")
        state[f"{name}.{_DBNET_LEAVES[collection][leaf]}"] = torch.from_numpy(
            np.ascontiguousarray(arr))
        if leaf == "mean":
            state[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state
