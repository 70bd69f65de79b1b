"""STTN weight loading: converted .npz, reference .pth, or a seeded random
init (this repo ships no trained weights)."""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.convert.from_flax import sttn_state_dict_from_flax


def init_random_(model: nn.Module, seed: int = 0) -> None:
    """LeCun-normal conv kernels and zero biases (the flax defaults), drawn
    from a torch.Generator seeded with ``seed`` on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p[0].numel()
                w = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
                p.copy_(w.to(p.dtype))


def load_sttn_weights(model: nn.Module, checkpoint_path: Optional[str] = None,
                      seed: int = 0) -> None:
    """Fill ``model``'s parameters in place from ``checkpoint_path``.

    ``.npz``: JAX-package params (read with numpy, converted with
    sttn_state_dict_from_flax). ``.pth``/``.pt``/``.ckpt``: a reference
    checkpoint's ``netG`` state dict. Missing or absent path: seeded random
    init, with a warning when a path was given."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        if checkpoint_path.endswith(".npz"):
            with np.load(checkpoint_path) as data:
                state = sttn_state_dict_from_flax({k: data[k] for k in data.files})
        elif checkpoint_path.endswith((".pth", ".pt", ".ckpt")):
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
