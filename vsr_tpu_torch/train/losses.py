"""GAN and masked L1 losses: counterpart of ``vsr_tpu/train/losses.py``
(the reference's backend/tools/train/loss_sttn.py:5-57)."""

from __future__ import annotations

import torch


def adversarial_loss(outputs: torch.Tensor, is_real: bool, is_disc: bool,
                     gan_type: str = "hinge") -> torch.Tensor:
    """hinge | nsgan | lsgan adversarial loss.

    hinge: disc -> mean(relu(1 -/+ out)); gen -> -mean(out). nsgan expects
    sigmoid outputs (the discriminator's ``use_sigmoid``)."""
    if gan_type == "hinge":
        if is_disc:
            signed = -outputs if is_real else outputs
            return torch.relu(1.0 + signed).mean()
        return -outputs.mean()
    label = 1.0 if is_real else 0.0
    if gan_type == "nsgan":
        return torch.mean(-(label * torch.log(outputs + 1e-8)
                            + (1 - label) * torch.log(1 - outputs + 1e-8)))
    if gan_type == "lsgan":
        return torch.mean((outputs - label) ** 2)
    raise ValueError(f"unknown gan loss: {gan_type}")


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1 over the masked region, normalised by the mask's density
    (trainer_sttn.py:289-303)."""
    return torch.mean(torch.abs(pred * mask - target * mask)) / torch.clamp(mask.mean(), min=1e-8)
