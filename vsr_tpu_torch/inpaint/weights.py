"""Weight loading for the STTN and DBNet models: converted .npz, reference
.pth (STTN), or a seeded random init (this repo ships no trained weights)."""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.convert.from_flax import (
    dbnet_state_dict_from_flax,
    sttn_state_dict_from_flax,
)


def init_random_(model: nn.Module, seed: int = 0) -> None:
    """LeCun-normal conv kernels and zero biases (the flax defaults), drawn
    from a torch.Generator seeded with ``seed`` on the CPU. BatchNorm layers
    get flax's start values instead: scale 1, bias 0, mean 0, var 1."""
    bn = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    bn_params = {id(p) for m in bn for p in m.parameters(recurse=False)}
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in bn:
            m.reset_parameters()  # weight 1, bias 0, running mean 0, var 1
        for name, p in model.named_parameters():
            if id(p) in bn_params:
                continue
            if name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p[0].numel()
                w = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
                p.copy_(w.to(p.dtype))


def _load_or_init(model: nn.Module, checkpoint_path: Optional[str], seed: int,
                  from_npz: Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]],
                  torch_checkpoints: bool) -> None:
    if checkpoint_path and os.path.exists(checkpoint_path):
        if checkpoint_path.endswith(".npz"):
            with np.load(checkpoint_path) as data:
                state = from_npz({k: data[k] for k in data.files})
        elif torch_checkpoints and checkpoint_path.endswith((".pth", ".pt", ".ckpt")):
            ckpt = torch.load(checkpoint_path, map_location="cpu")
            state = ckpt.get("netG", ckpt)
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

    ``.npz``: JAX-package params (read with numpy, converted with
    sttn_state_dict_from_flax). ``.pth``/``.pt``/``.ckpt``: a reference
    checkpoint's ``netG`` state dict. Missing or absent path: seeded random
    init, with a warning when a path was given."""
    _load_or_init(model, checkpoint_path, seed, sttn_state_dict_from_flax,
                  torch_checkpoints=True)


def load_dbnet_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                       seed: int = 0) -> None:
    """Fill a DBNet's parameters and BatchNorm statistics in place.

    ``.npz``: the JAX package's DBNet variables (params and batch_stats,
    converted with dbnet_state_dict_from_flax). Missing or absent path:
    seeded random init with flax's BatchNorm start values, with a warning
    when a path was given. Paddle checkpoints go through the JAX package's
    converter to .npz first (ROADMAP.md Queue 1 item 4)."""
    _load_or_init(model, checkpoint_path, seed, dbnet_state_dict_from_flax,
                  torch_checkpoints=False)
