"""Weight loading for the STTN, DBNet, LaMa and ProPainter models: converted
.npz, a reference checkpoint (STTN, RAFT, flow completion, ProPainter), or a
seeded random init (this repo ships no trained weights).

Both routes end in the JAX package's variable tree: a ``.npz`` holds it, and
a reference checkpoint becomes it through the port's converters
(``convert/torch_*.py``, copies of the JAX package's). The
``*_state_dict_from_flax`` maps then give the state dict, loaded strict."""

from __future__ import annotations

import functools
import math
import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.convert.__main__ import _load as load_reference
from vsr_tpu_torch.convert.from_flax import (
    dbnet_state_dict_from_flax,
    flow_completion_state_dict_from_flax,
    lama_state_dict_from_flax,
    propainter_state_dict_from_flax,
    raft_state_dict_from_flax,
    sttn_state_dict_from_flax,
)
from vsr_tpu_torch.detect.backbones import LearnableAffineBlock


def init_random_(model: nn.Module, seed: int = 0) -> None:
    """LeCun-normal kernels and zero biases (the flax defaults), drawn from a
    torch.Generator seeded with ``seed`` on the CPU. BatchNorm, LayerNorm
    and LCNetV3's affine blocks get flax's start values instead: scale 1,
    bias 0 (and BatchNorm mean 0, var 1); ProPainter's ``pool_kernel`` the
    average, 1 / (ph * pw)."""
    norms = [m for m in model.modules()
             if isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm,
                               LearnableAffineBlock))]
    norm_params = {id(p) for m in norms for p in m.parameters(recurse=False)}
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in norms:
            m.reset_parameters()  # weight 1, bias 0, running mean 0, var 1
        for name, p in model.named_parameters():
            if id(p) in norm_params:
                continue
            if name.endswith("bias"):  # .bias, and pool_bias
                p.zero_()
            elif name.endswith(".pool_kernel"):
                p.fill_(1.0 / p[0].numel())
            else:
                fan_in = p[0].numel()
                w = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
                p.copy_(w.to(p.dtype))


def _load_or_init(model: nn.Module, checkpoint_path: Optional[str], seed: int,
                  from_flax: Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]],
                  from_reference: Optional[Callable[[str], Dict]]) -> None:
    if checkpoint_path and os.path.exists(checkpoint_path):
        if checkpoint_path.endswith(".npz"):
            with np.load(checkpoint_path) as data:
                state = from_flax({k: data[k] for k in data.files})
        elif checkpoint_path.endswith((".pth", ".pt", ".ckpt")):
            if from_reference is None:
                raise ValueError(
                    f"{checkpoint_path}: a reference checkpoint of this model loads only "
                    "through its converter: convert to .npz first with `python -m "
                    "vsr_tpu_torch --prepare-models REF_MODELS_DIR --models DIR`")
            state = from_flax(from_reference(checkpoint_path))
        else:
            raise ValueError(f"unknown checkpoint format: {checkpoint_path}")
        model.load_state_dict(state, strict=True)
        return
    if checkpoint_path:
        warnings.warn(
            f"checkpoint not found at {checkpoint_path}; "
            "using random initialization (outputs will not be meaningful)"
        )
    init_random_(model, seed)


def load_sttn_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                      seed: int = 0) -> None:
    """Fill ``model``'s parameters in place from ``checkpoint_path``.

    ``.npz``: the JAX package's params (sttn_auto.npz / sttn_det.npz, read
    with numpy, mapped with sttn_state_dict_from_flax).
    ``.pth``/``.pt``/``.ckpt``: a reference checkpoint (its ``netG`` state
    dict), converted by convert/torch_sttn.py first. Missing or absent path:
    seeded random init, with a warning when a path was given."""
    _load_or_init(model, checkpoint_path, seed, sttn_state_dict_from_flax,
                  functools.partial(load_reference, "sttn-auto"))


def load_dbnet_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                       seed: int = 0) -> None:
    """Fill a DBNet's parameters and BatchNorm statistics in place.

    ``.npz``: the JAX package's DBNet variables (params and batch_stats,
    mapped with dbnet_state_dict_from_flax). Missing or absent path: seeded
    random init with flax's BatchNorm start values, with a warning when a
    path was given. Paddle checkpoints reach it through ``--prepare-models``
    (convert/paddle_dbnet.py); a ``.pth``/``.pt`` path raises, as in the JAX
    package."""
    _load_or_init(model, checkpoint_path, seed, dbnet_state_dict_from_flax, None)


def load_lama_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                      seed: int = 0) -> None:
    """Fill a LamaGenerator's parameters and BatchNorm statistics in place.

    ``.npz``: the JAX package's LamaGenerator variables (params and
    batch_stats, mapped with lama_state_dict_from_flax); a big-lama.pt
    reaches it through ``--prepare-models`` (convert/torch_lama.py). A
    ``.pth``/``.pt`` path raises, as in the JAX package. Missing or absent
    path: seeded random init with flax's BatchNorm start values, with a
    warning when a path was given."""
    _load_or_init(model, checkpoint_path, seed, lama_state_dict_from_flax, None)


def load_raft_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                      seed: int = 0) -> None:
    """Fill a RAFT's parameters and its context net's BatchNorm statistics
    in place. ``.npz``: the JAX package's RAFT variables (raft.npz, mapped
    with raft_state_dict_from_flax). ``.pth``: a reference raft-things.pth
    (``module.`` prefixes and all), converted by convert/torch_raft.py
    first. Missing or absent path: seeded random init, with a warning when
    a path was given."""
    _load_or_init(model, checkpoint_path, seed, raft_state_dict_from_flax,
                  functools.partial(load_reference, "raft"))


def load_flow_completion_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                                 seed: int = 0) -> None:
    """Fill a RecurrentFlowCompleteNet in place from flow_completion.npz
    (flow_completion_state_dict_from_flax) or a reference
    recurrent_flow_completion.pth (convert/torch_propainter.py); as
    load_raft_weights otherwise. A checkpoint's training-only edge head
    loads into a net built with it; a net without one (inference never
    calls it) leaves it out. Every tensor the net has is loaded strictly."""

    def from_flax(flat):
        state = flow_completion_state_dict_from_flax(flat)
        if model.edge is None:
            state = {k: v for k, v in state.items() if not k.startswith("edge.")}
        return state

    _load_or_init(model, checkpoint_path, seed, from_flax,
                  functools.partial(load_reference, "flow-completion"))


def load_propainter_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                            seed: int = 0) -> None:
    """Fill a ProPainterGenerator in place from propainter.npz
    (propainter_state_dict_from_flax) or a reference ProPainter.pth
    (convert/torch_propainter.py); as load_raft_weights otherwise."""
    _load_or_init(model, checkpoint_path, seed, propainter_state_dict_from_flax,
                  functools.partial(load_reference, "propainter"))
