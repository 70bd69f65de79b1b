"""Flow training losses: counterpart of ``vsr_tpu/train/flow_losses.py`` (the
reference's backend/inpaint/video/model/modules/flow_comp_raft.py:59-140 and
flow_loss_utils.py): first- and second-order masked smoothness and the
census (ternary) photometric loss.

The signatures are ``vsr_tpu``'s, channels last ([B, H, W, C]), as the
port's trainers keep at their boundaries; the warp inside ``flow_warp_loss``
is the port's ``ops/grid_sample.flow_warp`` (channels first, fp32
coordinates).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsr_tpu_torch.ops.grid_sample import flow_warp


def _grad_x(img: torch.Tensor) -> torch.Tensor:
    return img[:, :, :-1] - img[:, :, 1:]


def _grad_y(img: torch.Tensor) -> torch.Tensor:
    return img[:, :-1] - img[:, 1:]


def smoothness_loss(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First-order flow smoothness inside the mask.

    flow [B, H, W, 2]; mask [B, H, W, 1]."""
    mask_x = mask[:, :, :-1] * mask[:, :, 1:]
    mask_y = mask[:, :-1] * mask[:, 1:]
    loss = (_grad_x(flow).abs() * mask_x).mean() + (_grad_y(flow).abs() * mask_y).mean()
    return loss / 2.0


def second_order_smoothness_loss(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Second-order (curvature) smoothness inside the mask."""

    def gxx(x):
        return x[:, :, :-2] - 2 * x[:, :, 1:-1] + x[:, :, 2:]

    def gyy(x):
        return x[:, :-2] - 2 * x[:, 1:-1] + x[:, 2:]

    mask_x = mask[:, :, :-2] * mask[:, :, 1:-1] * mask[:, :, 2:]
    mask_y = mask[:, :-2] * mask[:, 1:-1] * mask[:, 2:]
    return ((gxx(flow).abs() * mask_x).mean() + (gyy(flow).abs() * mask_y).mean()) / 2.0


def _ternary_transform(img: torch.Tensor, patch: int = 7) -> torch.Tensor:
    """Census transform: each pixel's normalised differences to its patch.

    img [B, H, W, C] in [0, 1] -> [B, H, W, patch * patch]."""
    gray = (img * 255.0).mean(dim=-1, keepdim=True)
    pad = patch // 2
    padded = F.pad(gray[..., 0], (pad, pad, pad, pad))
    _, H, W, _ = img.shape
    neighbors = torch.stack([padded[:, i:i + H, j:j + W]
                             for i in range(patch) for j in range(patch)], dim=-1)
    diff = neighbors - gray
    return diff / torch.sqrt(0.81 + diff * diff)


def ternary_loss(frame1: torch.Tensor, warped_frame2: torch.Tensor, valid_mask: torch.Tensor,
                 patch: int = 7) -> torch.Tensor:
    """Census-transform photometric distance between frame1 and the
    flow-warped frame2, masked by flow validity and by the border that the
    patch cannot cover. Frames [B, H, W, 3] in [0, 1]; mask [B, H, W, 1]."""
    t1 = _ternary_transform(frame1, patch)
    t2 = _ternary_transform(warped_frame2, patch)
    dist = (t1 - t2) ** 2
    dist = (dist / (0.1 + dist)).sum(dim=-1, keepdim=True)
    pad = patch // 2
    inner = torch.zeros_like(valid_mask)
    inner[:, pad:-pad, pad:-pad] = 1.0
    mask = valid_mask * inner
    return (dist * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def flow_warp_loss(frame1: torch.Tensor, frame2: torch.Tensor, flow_f: torch.Tensor,
                   valid_mask: torch.Tensor) -> torch.Tensor:
    """Warp frame2 by the forward flow [B, H, W, 2] and census-compare it to
    frame1 (both [B, H, W, 3] in [0, 1])."""
    warped = flow_warp(frame2.permute(0, 3, 1, 2), flow_f.permute(0, 3, 1, 2))
    return ternary_loss(frame1, warped.permute(0, 2, 3, 1), valid_mask)
