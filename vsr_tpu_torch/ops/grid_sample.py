"""Bilinear / nearest sampling in pixel coordinates with zeros padding, and
``flow_warp``: counterpart of ``vsr_tpu/ops/grid_sample.py``.

The reference calls ``F.grid_sample(align_corners=True,
padding_mode='zeros')`` on coordinates normalised with 2x/(W-1)-1, which
align_corners maps straight back to pixels; here the samplers take the
pixels directly. ``F.grid_sample`` itself is not used: its normalise /
denormalise round trip can move a ``nearest`` sample across a .5 boundary,
and image propagation samples nearest.

Each sampler is one gather per corner over the flattened H*W axis, every
channel at the same index, with the JAX package's floor, weights and
in-bounds tests: a corner outside the image contributes zero.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch


def _tap(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W]; xi, yi [B, N] float integer-valued -> [B, C, N],
    zero where (xi, yi) lies outside the image."""
    B, C, H, W = img.shape
    inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
    idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
    vals = torch.gather(img.reshape(B, C, H * W), 2, idx[:, None, :].expand(B, C, -1))
    return vals * inb[:, None, :].to(img.dtype)


def _out(vals: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """[B, C, N] -> [B, C, *coords.shape[1:-1]]."""
    return vals.reshape(*vals.shape[:2], *coords.shape[1:-1])


def grid_sample_bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W]; coords [B, ..., 2] (x, y) pixel coordinates ->
    [B, C, ...]. Out-of-image corners contribute zero."""
    flat = coords.reshape(img.shape[0], -1, 2)
    x, y = flat[..., 0], flat[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (x - x0).to(img.dtype)[:, None, :]
    wy = (y - y0).to(img.dtype)[:, None, :]
    v00 = _tap(img, x0, y0)
    v01 = _tap(img, x0 + 1, y0)
    v10 = _tap(img, x0, y0 + 1)
    v11 = _tap(img, x0 + 1, y0 + 1)
    out = (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11)
    return _out(out, coords)


def grid_sample_nearest(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour variant: coordinates rounded half to even."""
    flat = coords.reshape(img.shape[0], -1, 2)
    return _out(_tap(img, torch.round(flat[..., 0]), torch.round(flat[..., 1])), coords)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = "bilinear") -> torch.Tensor:
    """Warp x [B, C, H, W] by flow [B, 2, H, W] ((dx, dy) channels):
    output(p) = x(p + flow(p)). The coordinates are fp32 whatever the
    flow's dtype (the JAX package forms them in the flow's dtype, which in
    bf16 rounds x = 479 to 480)."""
    B, _, H, W = flow.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=flow.device),
                            torch.arange(W, device=flow.device), indexing="ij")
    base = torch.stack([xs, ys], dim=-1).float()  # [H, W, 2]
    coords = base[None] + flow.permute(0, 2, 3, 1).float()
    if interpolation == "nearest":
        return grid_sample_nearest(x, coords)
    return grid_sample_bilinear(x, coords)
