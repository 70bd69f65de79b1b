"""JAX-package params -> the port's state dicts.

STTN: inverts the key map of ``vsr_tpu/convert/torch_sttn.py`` (copied here:
that module imports jax) and transposes conv kernels HWIO -> OIHW.
DBNet and LaMa: the port's modules carry the flax names, so the map is
structural (see dbnet_state_dict_from_flax, lama_state_dict_from_flax).
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


# flax leaf -> torch entry, per variable collection (params/scale is a
# BatchNorm's)
_FLAX_LEAVES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}
# LCNetV3's LearnableAffineBlock modules (``lab``, ``act_lab``): flax params
# ``scale`` and ``bias``, both of shape (1,), and nothing else
_AFFINE_MODULES = ("lab", "act_lab")
_AFFINE_LEAVES = {"scale": "weight", "bias": "bias"}


def _structural_state_dict(flat: Mapping[str, Any], what: str,
                           skip=lambda module: False) -> Dict[str, torch.Tensor]:
    """Flax variables -> state dict of a port module that carries the flax
    module names: the map shared by the DBNet and LaMa converters."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(flat).items():
        collection, rest = path.split("/", 1)
        if collection not in _FLAX_LEAVES:
            raise KeyError(f"unrecognized {what} variable collection: {path}")
        module, leaf = rest.rsplit("/", 1)
        if skip(module):
            continue
        leaves = _FLAX_LEAVES[collection]
        if module.rsplit("/", 1)[-1] in _AFFINE_MODULES:
            leaves = _AFFINE_LEAVES if collection == "params" else {}
        if leaf not in leaves:
            raise KeyError(f"unrecognized {what} param: {path}")
        arr = np.array(value, dtype=np.float32)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        name = module.replace("/", ".")
        state[f"{name}.{leaves[leaf]}"] = torch.from_numpy(np.ascontiguousarray(arr))
        if leaf == "mean":
            state[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state


def dbnet_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax DBNet variables (the '/'-joined flat dict that
    ``vsr_tpu.convert.params_io.save_params`` writes, or the nested dict with
    'params' and 'batch_stats') -> the port's DBNet state dict.

    Module paths map by name ('/' -> '.'). Conv kernels HWIO -> OIHW (a
    depthwise (k, k, 1, C) -> (C, 1, k, k)); a
    ``nn.ConvTranspose(transpose_kernel=True)`` kernel (kh, kw, O, I) ->
    ConvTranspose2d (I, O, kh, kw), the same axis permutation (the inverse
    of vsr_tpu/convert/mapping.py's convtranspose2d rule). BatchNorm scale,
    bias, mean and var -> weight, bias, running_mean, running_var (both use
    eps 1e-5). A LearnableAffineBlock (``lab``, ``act_lab``) takes only
    scale and bias -> weight and bias. The training-only ``head/thresh``
    branch is dropped: the port's head has no such branch. Any other
    unknown key raises.
    """
    return _structural_state_dict(flat, "DBNet",
                                  skip=lambda module: module.startswith("head/thresh/"))


# LamaGenerator's modules (vsr_tpu/models/lama.py), '/'-joined
_LAMA_FFC = r"ffc/(l2l|l2g|g2l|g2g/(conv1|bn1|conv2|fu/conv|fu/bn))|bn_l|bn_g"
_LAMA_MODULE = re.compile(
    rf"stem|stem_bn|head|up\d+|up\d+_bn|(down\d+|block\d+/conv[12])/({_LAMA_FFC})")


def lama_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax LamaGenerator variables ('params' and 'batch_stats', nested or
    '/'-joined as ``save_params`` writes them) -> the port's LamaGenerator
    state dict.

    This is how the JAX package's parameters reach the port, and with them
    a big-lama.pt that ``vsr_tpu/convert/torch_lama.py`` converted. Module
    paths map by name (``block3/conv1/ffc/g2g/fu/conv`` ->
    ``block3.conv1.ffc.g2g.fu.conv``). Conv kernels HWIO -> OIHW; the up
    convs' ``nn.ConvTranspose(transpose_kernel=True)`` kernels (kh, kw, O,
    I) -> ConvTranspose2d (I, O, kh, kw), no flip; BatchNorm scale, bias,
    mean and var -> weight, bias, running_mean, running_var. A module that
    is not the generator's, or an unknown leaf or collection, raises.
    """
    flat = _flatten(flat)
    for path in flat:
        module = path.split("/", 1)[-1].rsplit("/", 1)[0]
        if not _LAMA_MODULE.fullmatch(module):
            raise KeyError(f"unrecognized LaMa module: {path}")
    return _structural_state_dict(flat, "LaMa")
