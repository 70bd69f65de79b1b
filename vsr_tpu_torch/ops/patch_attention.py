"""Multi-scale spatio-temporal patch attention (PyTorch).

Counterpart of ``vsr_tpu/ops/patch_attention.py``, with the same token order
so converted weights and the JAX package agree. Scales whose token width
D = ph*pw*dk is at most KERNEL_D_MAX (the small-patch scales, whose [N, N]
score tensors are large) go to the token-attention kernel when
``use_kernel`` is set; the big-patch scales (few tokens, D up to ~77k) take
the dense matmul + softmax path, as the JAX package left them to XLA.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from vsr_tpu_torch.ops.token_attention import flash_token_attention

NEG_INF = -1e9

# Widest token embedding routed to the kernel (vsr_tpu/ops/patch_attention.py:44).
KERNEL_D_MAX = 4096


def _tokens_to_grid(y: torch.Tensor, B: int, L: int, out_h: int, out_w: int,
                    ph: int, pw: int, dk: int) -> torch.Tensor:
    """[B, N, D] tokens -> [B, L, h, w, dk] feature grid (inverse of _grid_to_tokens)."""
    y = y.reshape(B, L, out_h, out_w, ph, pw, dk)
    y = y.permute(0, 1, 2, 4, 3, 5, 6)  # B, L, out_h, ph, out_w, pw, dk
    return y.reshape(B, L, out_h * ph, out_w * pw, dk)


def _grid_to_tokens(x: torch.Tensor, ph: int, pw: int
                    ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[B, L, h, w, dk] -> contiguous [B, N, D] patch tokens, plus the dims
    that invert it."""
    B, L, h, w, dk = x.shape
    out_h, out_w = h // ph, w // pw
    x = x.reshape(B, L, out_h, ph, out_w, pw, dk)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)  # B, L, out_h, out_w, ph, pw, dk
    tokens = x.reshape(B, L * out_h * out_w, ph * pw * dk).contiguous()
    return tokens, (B, L, out_h, out_w, ph, pw, dk)


def patch_attention_single_scale(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patch: Tuple[int, int],
    key_valid: Optional[torch.Tensor] = None,
    patch_masked: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention over one patch tiling.

    q, k, v: [B, L, h, w, dk]; patch: (pw, ph), width first as in the
    reference's patch sizes; key_valid: optional [B, L] bool, False frames
    leave the key set; patch_masked: optional [B, L, h, w] hole mask, a key
    token whose patch mean is over 0.5 leaves the key set (det variant).
    Returns [B, L, h, w, dk].
    """
    pw, ph = patch
    B, L, h, w, dk = q.shape
    out_h, out_w = h // ph, w // pw
    n_spatial = out_h * out_w

    qt, _ = _grid_to_tokens(q, ph, pw)
    kt, _ = _grid_to_tokens(k, ph, pw)
    vt, _ = _grid_to_tokens(v, ph, pw)

    D = qt.shape[-1]
    key_bias = None
    if key_valid is not None:
        token_valid = key_valid.repeat_interleave(n_spatial, dim=1)  # [B, N]
        key_bias = torch.where(token_valid, 0.0, NEG_INF).float()
    if patch_masked is not None:
        pm, _ = _grid_to_tokens(patch_masked[..., None].float(), ph, pw)
        mb = torch.where(pm.mean(dim=-1) > 0.5, NEG_INF, 0.0).float()
        key_bias = mb if key_bias is None else key_bias + mb

    if use_kernel and D <= KERNEL_D_MAX:
        y = flash_token_attention(qt, kt, vt, key_bias)
        return _tokens_to_grid(y, B, L, out_h, out_w, ph, pw, dk)

    scale = 1.0 / math.sqrt(D)
    scores = torch.matmul(qt.float(), kt.float().transpose(1, 2)) * scale
    if key_bias is not None:
        scores = scores + key_bias[:, None, :]
    attn = torch.softmax(scores, dim=-1)
    y = torch.matmul(attn.to(vt.dtype).float(), vt.float()).to(q.dtype)
    return _tokens_to_grid(y, B, L, out_h, out_w, ph, pw, dk)


def multi_scale_patch_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    patchsizes: Sequence[Tuple[int, int]],
    key_valid: Optional[torch.Tensor] = None,
    patch_mask: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Split the channels of [B, L, h, w, C] q/k/v into len(patchsizes)
    groups, attend per scale, and concatenate the groups back in order."""
    dk = q.shape[-1] // len(patchsizes)
    outs: List[torch.Tensor] = []
    for s, patch in enumerate(patchsizes):
        sl = slice(s * dk, (s + 1) * dk)
        outs.append(patch_attention_single_scale(
            q[..., sl], k[..., sl], v[..., sl], patch, key_valid=key_valid,
            patch_masked=patch_mask, use_kernel=use_kernel))
    return torch.cat(outs, dim=-1)
