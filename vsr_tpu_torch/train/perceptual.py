"""Perceptual (VGG) and LPIPS training losses: counterpart of
``vsr_tpu/train/perceptual.py`` (the reference's PerceptualLoss and
LPIPSLoss, backend/inpaint/video/core/loss.py:6-144): a weighted per-layer
feature distance (l1 / mse / fro) with an optional Gram-matrix style term,
and the LPIPS loss with the reference's input normalisation.

Both take the frozen feature network as a module (``VGGFeatures``,
``LPIPS``); gradients reach the prediction only, the target's features are
computed without them (the reference detaches gt, loss.py:71). Images are
[B, 3, H, W].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vsr_tpu_torch.models.lpips import LPIPS
from vsr_tpu_torch.models.vgg import IMAGENET_MEAN, IMAGENET_STD, VGGFeatures, channel_constant


def _criterion(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "l1":
        return torch.mean(torch.abs(a - b))
    if kind in ("l2", "mse"):
        return torch.mean((a - b) ** 2)
    if kind == "fro":
        return torch.linalg.norm((a - b).reshape(-1))
    raise NotImplementedError(f"{kind} criterion has not been supported.")


def _gram(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, C] Gram matrix (ref loss.py:102-114)."""
    b, c, h, w = x.shape
    f = x.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


def perceptual_loss(vgg: VGGFeatures, pred: torch.Tensor, gt: torch.Tensor,
                    layer_weights: Dict[str, float], perceptual_weight: float = 1.0,
                    style_weight: float = 0.0, criterion: str = "l1"
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(perceptual, style) losses, None for a zero-weighted term. ``vgg``
    returns at least the layers of ``layer_weights`` and carries the
    flavour and input normalisation."""
    missing = set(layer_weights) - set(vgg.layers)
    if missing:
        raise ValueError(f"the VGG trunk does not return {sorted(missing)}")
    fx = vgg(pred)
    with torch.no_grad():
        fgt = vgg(gt)
    percep = style = None
    if perceptual_weight > 0:
        percep = sum(_criterion(fx[k], fgt[k], criterion) * w
                     for k, w in layer_weights.items()) * perceptual_weight
    if style_weight > 0:
        style = sum(_criterion(_gram(fx[k]), _gram(fgt[k]), criterion) * w
                    for k, w in layer_weights.items()) * style_weight
    return percep, style


def lpips_loss(lpips: LPIPS, pred: torch.Tensor, target: torch.Tensor,
               loss_weight: float = 1.0, use_input_norm: bool = True,
               range_norm: bool = False) -> torch.Tensor:
    """The reference LPIPSLoss forward (loss.py:133-144): optional
    [-1, 1] -> [0, 1], then ImageNet normalisation, then the LPIPS metric
    (target first, as the reference calls it), averaged over the batch."""
    if range_norm:
        pred = (pred + 1.0) / 2.0
        target = (target + 1.0) / 2.0
    if use_input_norm:
        mean, std = channel_constant(IMAGENET_MEAN, pred), channel_constant(IMAGENET_STD, pred)
        pred = (pred - mean) / std
        target = (target - mean) / std
    return loss_weight * lpips(target, pred).mean()
