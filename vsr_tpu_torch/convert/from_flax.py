"""JAX-package params -> the port's state dicts.

STTN: inverts the key map of ``convert/torch_sttn.py`` (the port's copy of
the JAX package's converter) and transposes conv kernels HWIO -> OIHW.
DBNet, LaMa, ProPainter's three networks, and the training networks (the
video discriminator, VGG, LPIPS): the port's modules carry the flax module
names, so the map is structural (see _structural_state_dict).
Reference checkpoints reach these maps through the converters beside this
module, which write the JAX package's variable tree.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vsr_tpu_torch.convert import torch_sttn
from vsr_tpu_torch.convert.mapping import flatten_tree as _flatten

_ENCODER = {v: k for k, v in torch_sttn.ENCODER.items()}
_DECODER = {v: k for k, v in torch_sttn.DECODER.items()}
_ATTN = {v: k for k, v in torch_sttn.ATTN.items()}


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
# BatchNorm's or a LayerNorm's weight; pool_kernel / pool_bias sit on
# ProPainter's SparseWindowAttention itself)
_FLAX_LEAVES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight",
               "pool_kernel": "pool_kernel", "pool_bias": "pool_bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}
# LCNetV3's LearnableAffineBlock modules (``lab``, ``act_lab``): flax params
# ``scale`` and ``bias``, both of shape (1,), and nothing else
_AFFINE_MODULES = ("lab", "act_lab")
_AFFINE_LEAVES = {"scale": "weight", "bias": "bias"}
# a kernel's axes, by rank: Dense (in, out) -> Linear (out, in); Conv HWIO
# -> OIHW (a depthwise (k, k, 1, C) -> (C, 1, k, k); an
# nn.ConvTranspose(transpose_kernel=True) (kh, kw, O, I) -> ConvTranspose2d
# (I, O, kh, kw)); Conv3d DHWIO -> OIDHW
_KERNEL_AXES = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
# flax module names that are nn.Module attributes in torch (``forward``)
_TORCH_NAMES = {"forward": "forward_sweep", "backward": "backward_sweep"}


def _structural_state_dict(flat: Mapping[str, Any], what: str,
                           skip=lambda module: False) -> Dict[str, torch.Tensor]:
    """Flax variables -> state dict of a port module that carries the flax
    module names: the map shared by every converter but STTN's. Module paths
    map by name ('/' -> '.', with _TORCH_NAMES), leaves by _FLAX_LEAVES,
    kernels by rank (_KERNEL_AXES). Params that sit on a module itself
    (``align/kernel``) map like a child's. An ``nn.scan`` broadcasts its
    params over time, so its tree holds one copy, mapped as any other."""
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
        if leaf in ("kernel", "pool_kernel"):
            if arr.ndim not in _KERNEL_AXES:
                raise KeyError(f"unrecognized {what} kernel rank {arr.ndim}: {path}")
            arr = arr.transpose(_KERNEL_AXES[arr.ndim])
        name = ".".join(_TORCH_NAMES.get(part, part) for part in module.split("/"))
        state[f"{name}.{leaves[leaf]}"] = torch.from_numpy(np.ascontiguousarray(arr))
        if leaf == "mean":
            state[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state


def _checked_state_dict(flat: Mapping[str, Any], modules: "re.Pattern", what: str,
                        skip=lambda module: False) -> Dict[str, torch.Tensor]:
    """_structural_state_dict after checking that every module path is one
    of the model's (``modules``); another raises."""
    flat = _flatten(flat)
    for path in flat:
        module = path.split("/", 1)[-1].rsplit("/", 1)[0]
        if not skip(module) and not modules.fullmatch(module):
            raise KeyError(f"unrecognized {what} module: {path}")
    return _structural_state_dict(flat, what, skip)


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
    return _checked_state_dict(flat, _LAMA_MODULE, "LaMa")


# ProPainter's networks (vsr_tpu/models/propainter/), '/'-joined module paths
_RAFT_MODULE = re.compile(
    r"(fnet|cnet)/(conv1|conv2|norm1/bn|layer[0-5]/(conv1|conv2|down|norm[123]/bn))"
    r"|step/update/(encoder/conv(c1|c2|f1|f2)?|gru/conv[zrq][12]|flow[12]|mask[12])")
_FLOW_MODULE = re.compile(
    r"down|enc[12][ab]/conv[12]|mid[0-2]|prop/fusion|(dec2a|dec2b|dec1a|dec1b|upa|upb)/conv"
    r"|prop/(backward|forward)/(align(/off[0-3]/conv)?|bb[12]/conv)|edge/((proj|mid[12])/conv|out)")
_PROPAINTER_MODULE = re.compile(
    r"encoder/c[0-8]|ss/embedding|sc/(embedding|bias_conv)|dec_(deconv0|conv1|deconv1|conv2)"
    r"|feat_prop_module/((backward|forward)/(align(/off[0-3])?|bb[01])|fuse[01])"
    r"|block\d+/(norm[12]|attention(/(query|key|value|proj))?|mlp/fc[12])")


def raft_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax RAFT variables ('params' and the context net's 'batch_stats',
    nested or '/'-joined) -> the port's RAFT state dict. The update block
    sits under the GRU scan's name (``step/update/...``), one copy: the
    scan broadcasts it over the iterations. A module that is not RAFT's, or
    an unknown leaf or collection, raises."""
    return _checked_state_dict(flat, _RAFT_MODULE, "RAFT")


def flow_completion_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax RecurrentFlowCompleteNet params -> the port's state dict. Conv3d
    kernels DHWIO -> OIDHW; each sweep's alignment kernel and bias sit on
    ``prop/<sweep>/align`` itself. The training-only edge head (``edge/``,
    in a flax init with ``train=True`` and in every reference checkpoint)
    maps to ``edge.*`` when the tree has it: it loads into a net built with
    ``edge_head=True``. An unknown module or leaf raises."""
    return _checked_state_dict(flat, _FLOW_MODULE, "flow completion")


def propainter_state_dict_from_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ProPainterGenerator params -> the port's state dict. Dense
    kernels (in, out) -> Linear (out, in); the depthwise ``pool_kernel``
    (ph, pw, 1, C) -> (C, 1, ph, pw); LayerNorm scale -> weight; the
    feature-propagation sweeps' params, one copy each under their scan's
    name. An unknown module or leaf raises."""
    return _checked_state_dict(flat, _PROPAINTER_MODULE, "ProPainter")


_VGG_MODULE = re.compile(r"conv[1-5]_[1-4]")
_LPIPS_MODULE = re.compile(r"net/conv[1-5]_[1-3]|lin[0-4]")
_DIS_PARAM = re.compile(r"conv[0-5]")
_DIS_STAT = re.compile(r"SpectralNorm_(\d)/conv(\d)/kernel/(u|sigma)")


def _params(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A params tree with or without its top-level 'params', flattened and
    put under 'params/'."""
    flat = _flatten(tree)
    return {k if k.startswith("params/") else f"params/{k}": v for k, v in flat.items()}


def vgg_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax VGGFeatures params (with or without the top-level 'params') ->
    the port's VGGFeatures state dict (``conv3_2.weight``, OIHW)."""
    return _checked_state_dict(_params(params), _VGG_MODULE, "VGG")


def lpips_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax LPIPS params -> the port's LPIPS state dict: the vgg16 trunk
    under ``net.`` and the bias-free 1x1 heads ``lin0``..``lin4``."""
    return _checked_state_dict(_params(params), _LPIPS_MODULE, "LPIPS")


def discriminator_state_dict_from_flax(params: Mapping[str, Any],
                                       batch_stats: Optional[Mapping[str, Any]] = None
                                       ) -> Dict[str, torch.Tensor]:
    """Flax VideoDiscriminator variables -> the port's state dict.

    params: ``conv{i}/kernel`` (DHWIO -> OIDHW; conv0..conv4 without bias
    under spectral norm) and ``conv5/{kernel,bias}``, with or without the
    top-level 'params'. batch_stats: the spectral norms' power-iteration
    state, ``SpectralNorm_{i}/conv{i}/kernel/{u,sigma}`` -> ``conv{i}.u``
    [1, Cout] and ``conv{i}.sigma`` (with or without a top-level
    'batch_stats'). An unknown module or leaf raises."""
    state = _checked_state_dict(_params(params), _DIS_PARAM, "discriminator")
    for path, value in _flatten(batch_stats or {}).items():
        path = path[len("batch_stats/"):] if path.startswith("batch_stats/") else path
        m = _DIS_STAT.fullmatch(path)
        if not m or m.group(1) != m.group(2):
            raise KeyError(f"unrecognized discriminator statistic: {path}")
        state[f"conv{m.group(2)}.{m.group(3)}"] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return state
