"""ProPainter inpainting generator: counterpart of
``vsr_tpu/models/propainter/generator.py`` (the reference's
model/propainter.py:259-378 and modules/sparse_transformer.py).

A grouped-skip conv encoder, parameter-free image propagation (flow warps
gated by forward-backward consistency), learnable feature propagation with
flow-guided deformable alignment, SoftSplit / SoftComp tokenisation (unfold
k7 s3 p3 + linear), temporal sparse window transformer blocks (windows of
(5, 9) tokens, pooled global tokens, temporal dilation 2) and a conv
decoder. The sequential propagations are Python loops over time.

Modules carry the flax names (``encoder.c5``, ``block3.attention.key``,
``block3.norm1``, ``sc.bias_conv``); flax's ``feat_prop_module/backward``
and ``/forward`` are ``backward_sweep`` / ``forward_sweep`` (``forward`` is
nn.Module's method). The JAX package's variables load through
``convert.from_flax.propainter_state_dict_from_flax``.

Layouts: videos [B, T, C, H, W] (per-frame NCHW); flows [B, T-1, 2, H, W]
with (x, y) channels; tokens channels-last [B, T, fh, fw, hidden], as the
linear layers want them. The net computes in the dtype of its parameters;
attention logits and softmax are fp32, and the decoder's output is
returned in fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.ops.deform_conv import modulated_deform_conv
from vsr_tpu_torch.ops.grid_sample import flow_warp
from vsr_tpu_torch.ops.unfold import fold, fold_normalizer, unfold
from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners

_KERNEL, _STRIDE, _PADDING = (7, 7), (3, 3), (3, 3)  # SoftSplit / SoftComp / FFN


def _lrelu(x: torch.Tensor, s: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, s)


def _conv(cin: int, cout: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups)


def length_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=1, keepdim=True)


def fb_consistency_check(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                         alpha1: float = 0.01, alpha2: float = 0.5) -> torch.Tensor:
    """Forward-backward flow agreement -> validity in {0, 1}, [B, 1, H, W]
    (propainter.py:24-33). Flows are [B, 2, H, W]."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    flow_diff_fw = flow_fw + flow_bw_warped
    mag_sq_fw = length_sq(flow_fw) + length_sq(flow_bw_warped)
    occ_thresh_fw = alpha1 * mag_sq_fw + alpha2
    return (length_sq(flow_diff_fw) < occ_thresh_fw).to(flow_fw.dtype)


def binary_mask(mask: torch.Tensor, th: float = 0.1) -> torch.Tensor:
    return (mask > th).to(mask.dtype)


def _sweep_order(T: int, reverse: bool):
    """(frame, index of the flow that reaches it or None) in sweep order:
    a backward sweep reaches frame t with flow t (t -> t+1), a forward
    sweep with flow t-1."""
    if reverse:
        return [(t, None if t == T - 1 else t) for t in range(T - 1, -1, -1)]
    return [(t, None if t == 0 else t - 1) for t in range(T)]


# ---------------------------------------------------------------- encoder

class ProPainterEncoder(nn.Module):
    """Conv encoder with grouped skip concatenations (propainter.py:196-235):
    64-64-128-256-384, then grouped convs 512 (g2), 384 (g4), 256 (g8) and
    ``channel`` (g1) over the skip interleaved with the features. Widths
    scale with channel / 128, at least 8."""

    def __init__(self, channel: int = 128):
        super().__init__()
        m = channel / 128.0

        def wdt(base):
            return max(8, int(base * m))

        skip = wdt(256)
        self.c0 = _conv(5, wdt(64), stride=2)
        self.c1 = _conv(wdt(64), wdt(64))
        self.c2 = _conv(wdt(64), wdt(128), stride=2)
        self.c3 = _conv(wdt(128), skip)
        self.c4 = _conv(skip, wdt(384))
        self.c5 = _conv(skip + wdt(384), wdt(512), groups=2)
        self.c6 = _conv(skip + wdt(512), wdt(384), groups=4)
        self.c7 = _conv(skip + wdt(384), wdt(256), groups=8)
        self.c8 = _conv(skip + wdt(256), channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 5, H, W] -> [N, channel, H/4, W/4]."""
        out = _lrelu(self.c0(x))
        out = _lrelu(self.c1(out))
        out = _lrelu(self.c2(out))
        x0 = _lrelu(self.c3(out))
        out = _lrelu(self.c4(x0))
        N, _, h, w = x0.shape

        def group_cat(feat, g):
            return torch.cat([x0.reshape(N, g, -1, h, w), feat.reshape(N, g, -1, h, w)],
                             dim=2).reshape(N, -1, h, w)

        out = _lrelu(self.c5(group_cat(out, 2)))
        out = _lrelu(self.c6(group_cat(out, 4)))
        out = _lrelu(self.c7(group_cat(out, 8)))
        return _lrelu(self.c8(group_cat(out, 1)))


# ------------------------------------------------- image-level propagation

def image_propagation_sweep(frames, masks, flows_prop, flows_check, reverse: bool,
                            interpolation: str = "nearest"):
    """One direction of the parameter-free image propagation
    (propainter.py:140-173): frames [B, T, 3, H, W], masks [B, T, 1, H, W],
    flows [B, T-1, 2, H, W]."""
    T = frames.shape[1]
    feats, masks_out = [None] * T, [None] * T
    feat_prop = mask_prop = None
    for t, fi in _sweep_order(T, reverse):
        feat_current, mask_current = frames[:, t], masks[:, t]
        if fi is None:
            feat_prop, mask_prop = feat_current, mask_current
        else:
            flow_prop = flows_prop[:, fi]
            valid = fb_consistency_check(flow_prop, flows_check[:, fi])
            feat_warped = flow_warp(feat_prop, flow_prop, interpolation)
            mask_prop_valid = binary_mask(flow_warp(mask_prop, flow_prop))
            union = binary_mask(mask_current * valid * (1 - mask_prop_valid))
            feat_prop = union * feat_warped + (1 - union) * feat_current
            mask_prop = binary_mask(mask_current * (1 - valid * (1 - mask_prop_valid)))
        feats[t], masks_out[t] = feat_prop, mask_prop
    return torch.stack(feats, 1), torch.stack(masks_out, 1)


def image_propagation(frames, masks, flows_f, flows_b, interpolation: str = "nearest"):
    """Bidirectional image propagation (propainter.py:316-319): a backward
    sweep over the inputs, then a forward sweep over its results."""
    feats_b, masks_b = image_propagation_sweep(frames, masks, flows_f, flows_b, True,
                                               interpolation)
    return image_propagation_sweep(feats_b, masks_b, flows_b, flows_f, False, interpolation)


# ------------------------------------------------ feature-level propagation

class DeformableAlignment(nn.Module):
    """Flow-guided first-order deformable alignment (propainter.py:36-72):
    each tap samples at position + tap + flow + a tanh-bounded residual
    (bound 3.0)."""

    def __init__(self, channels: int = 128, deform_groups: int = 16,
                 max_residue_magnitude: float = 3.0):
        super().__init__()
        c, G = channels, deform_groups
        self.G, self.bound = G, max_residue_magnitude
        self.off0 = _conv(2 * c + 5, c)
        self.off1 = _conv(c, c)
        self.off2 = _conv(c, c)
        self.off3 = _conv(c, 27 * G)
        self.weight = nn.Parameter(torch.empty(c, c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, cond, flow):
        feat = cond
        for conv in (self.off0, self.off1, self.off2):
            feat = _lrelu(conv(feat), 0.1)
        out = self.off3(feat)
        B, _, H, W = out.shape
        G = self.G
        # (dy, dx) per tap: the residual plus the flow, whose channels are (x, y)
        offset = (self.bound * torch.tanh(out[:, :18 * G].float()).reshape(B, G, 9, 2, H, W)
                  + flow.flip(1).float()[:, None, None])
        modulation = torch.sigmoid(out[:, 18 * G:]).reshape(B, G, 9, H, W)
        return modulated_deform_conv(x, offset, modulation, self.weight, self.bias)


class _FeatSweepStep(nn.Module):
    """One time step's modules of a feature propagation sweep."""

    def __init__(self, channels: int):
        super().__init__()
        self.align = DeformableAlignment(channels)
        self.bb0 = _conv(2 * channels + 2, channels)
        self.bb1 = _conv(channels, channels)


class FeaturePropagation(nn.Module):
    """Learnable bidirectional feature propagation (propainter.py:75-193):
    the backward sweep reads the encoder features, the forward sweep the
    backward results; the fusion is residual."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.backward_sweep = _FeatSweepStep(channels)
        self.forward_sweep = _FeatSweepStep(channels)
        self.fuse0 = _conv(2 * channels + 2, channels)
        self.fuse1 = _conv(channels, channels)

    @staticmethod
    def _sweep(step_mod, seq_x, masks, flows_prop, flows_check, reverse, frame_valid):
        """frame_valid [B, T] bool or None: an invalid (padded) frame leaves
        its window's carried state and step counter untouched; its own
        output is discarded by the caller. The alignment is used from a
        window's second valid step on."""
        B, T, C, h, w = seq_x.shape
        feat_prop = seq_x.new_zeros((B, C, h, w))
        step = torch.zeros(B, dtype=torch.long, device=seq_x.device)
        outs = [None] * T
        for t, fi in _sweep_order(T, reverse):
            feat_current, mask_current = seq_x[:, t], masks[:, t]
            if frame_valid is None and fi is None:
                new_prop = feat_current
            else:
                if fi is None:
                    flow_prop = flow_check = seq_x.new_zeros((B, 2, h, w))
                else:
                    flow_prop, flow_check = flows_prop[:, fi], flows_check[:, fi]
                valid = fb_consistency_check(flow_prop, flow_check)
                feat_warped = flow_warp(feat_prop, flow_prop)
                cond = torch.cat([feat_current, feat_warped, flow_prop, valid, mask_current], 1)
                new_prop = step_mod.align(feat_prop, cond, flow_prop)
                if frame_valid is not None:
                    new_prop = torch.where((step > 0)[:, None, None, None], new_prop,
                                           feat_current)
            feat = torch.cat([feat_current, new_prop, mask_current], 1)
            new_prop = new_prop + step_mod.bb1(_lrelu(step_mod.bb0(feat)))
            if frame_valid is None:
                feat_prop = new_prop
            else:
                step_valid = frame_valid[:, t]
                feat_prop = torch.where(step_valid[:, None, None, None], new_prop, feat_prop)
                step = step + step_valid.long()
            outs[t] = new_prop
        return torch.stack(outs, 1)

    def forward(self, x, flows_f, flows_b, masks, frame_valid=None):
        """x [B, T, C, h, w]; flows [B, T-1, 2, h, w]; masks [B, T, 2, h, w]
        (mask_in, mask_updated), which feed the alignment's condition, the
        backbone and the fusion; frame_valid [B, T] bool or None."""
        B, T, C, h, w = x.shape
        feats_b = self._sweep(self.backward_sweep, x, masks, flows_f, flows_b, True, frame_valid)
        feats_f = self._sweep(self.forward_sweep, feats_b, masks, flows_b, flows_f, False,
                              frame_valid)
        fused_in = torch.cat([feats_b, feats_f, masks], dim=2).reshape(B * T, -1, h, w)
        y = self.fuse1(_lrelu(self.fuse0(fused_in)))
        return y.reshape(B, T, C, h, w) + x


# ------------------------------------------------------ token split / comp

class SoftSplit(nn.Module):
    def __init__(self, channel: int = 128, hidden: int = 512):
        super().__init__()
        self.embedding = nn.Linear(channel * _KERNEL[0] * _KERNEL[1], hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] -> tokens [N, fh, fw, hidden]."""
        return self.embedding(unfold(x, _KERNEL, _STRIDE, _PADDING))


class SoftComp(nn.Module):
    def __init__(self, channel: int = 128, hidden: int = 512):
        super().__init__()
        self.embedding = nn.Linear(hidden, _KERNEL[0] * _KERNEL[1] * channel)
        self.bias_conv = _conv(channel, channel)

    def forward(self, tokens: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        """tokens [N, fh, fw, hidden] -> [N, C, H, W] (overlap-add fold)."""
        img = fold(self.embedding(tokens), out_hw, _KERNEL, _STRIDE, _PADDING)
        return self.bias_conv(img)


class FusionFeedForward(nn.Module):
    """fc1, a fold / renormalise / unfold round trip over the token grid,
    exact GELU, fc2 (sparse_transformer.py:74-101)."""

    def __init__(self, dim: int = 512, hidden_dim: int = 1960):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        B, T, fh, fw, _ = x.shape
        x = self.fc1(x)
        img = fold(x.reshape(B * T, fh, fw, self.hidden_dim), out_hw, _KERNEL, _STRIDE,
                   _PADDING)
        norm = fold_normalizer(out_hw, _KERNEL, _STRIDE, _PADDING, fh, fw, img.dtype, img.device)
        img = img / norm.clamp_min(1e-9)
        tokens = unfold(img, _KERNEL, _STRIDE, _PADDING).reshape(B, T, fh, fw, self.hidden_dim)
        return self.fc2(F.gelu(tokens))


# -------------------------------------------------- sparse window attention

def _rolled_valid_indices(window_size: Tuple[int, int]) -> np.ndarray:
    """The reference's valid_ind_rolled buffer (sparse_transformer.py:142-153):
    which tokens of the four diagonally rolled windows are keys."""
    wh, ww = window_size
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    masks = []
    for tl_h, tl_w in ((0, 0), (0, 1), (1, 0), (1, 1)):
        m = np.ones((wh, ww), np.int64)
        hs = slice(eh, None) if tl_h else slice(None, -eh)
        ws = slice(ew, None) if tl_w else slice(None, -ew)
        m[hs, ws] = 0
        masks.append(m)
    return np.nonzero(np.stack(masks, 0).reshape(-1))[0]


def _window_partition(x: torch.Tensor, window: Tuple[int, int], n_head: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, nW, head, T, wh*ww, c_head]."""
    B, T, H, W, C = x.shape
    wh, ww = window
    nwh, nww = H // wh, W // ww
    x = x.reshape(B, T, nwh, wh, nww, ww, n_head, C // n_head)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(B, nwh * nww, n_head, T, wh * ww, C // n_head)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(c) + bias) v with fp32 logits and softmax; the
    probabilities go back to v's dtype for the second product."""
    att = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    if key_bias is not None:
        att = att + key_bias
    return torch.matmul(torch.softmax(att, dim=-1).to(v.dtype), v)


class SparseWindowAttention(nn.Module):
    def __init__(self, dim: int = 512, n_head: int = 4, window_size=(5, 9), pool_size=(4, 4)):
        super().__init__()
        self.n_head, self.window_size, self.pool_size = n_head, tuple(window_size), tuple(pool_size)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        # learned depthwise pool, started as the average (flax's init)
        self.pool_kernel = nn.Parameter(
            torch.full((dim, 1, *self.pool_size), 1.0 / (self.pool_size[0] * self.pool_size[1])))
        self.pool_bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("valid_idx", torch.from_numpy(
            _rolled_valid_indices(self.window_size)), persistent=False)

    def forward(self, x, mask, t_ind: Optional[Sequence[int]] = None, frame_valid=None,
                masked_windows: Optional[torch.Tensor] = None):
        """x [B, T, H, W, C] tokens; mask [B, lt, H, W] (the pooled hole
        mask of the local frames); t_ind: the frames whose keys the masked
        windows read (temporal dilation); frame_valid [B, T] bool or None:
        invalid frames are no keys of the masked windows.

        Windows that hold mask run full spatio-temporal attention over the
        window's tokens in frames t_ind, the four diagonally rolled windows'
        valid tokens and the pooled tokens (taken from the padded x through
        the shared key / value projections); the rest attend within their
        own frame. ``masked_windows`` [nM]: the masked windows' indices,
        computed by the caller for a mask that is the same in every frame;
        only those run the first branch. Without it every window runs both
        and the mask's occupancy picks. Returns [B, T, H, W, C]."""
        B, T, H, W, C = x.shape
        wh, ww = self.window_size
        head = self.n_head
        nwh, nww = math.ceil(H / wh), math.ceil(W / ww)
        pad_b, pad_r = nwh * wh - H, nww * ww - W
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            mask = F.pad(mask, (0, pad_r, 0, pad_b))
        Hp, Wp = nwh * wh, nww * ww
        S = wh * ww

        q, k, v = self.query(x), self.key(x), self.value(x)
        win_q = _window_partition(q, self.window_size, head)
        win_k = _window_partition(k, self.window_size, head)
        win_v = _window_partition(v, self.window_size, head)

        # ---- unmasked windows: attention within the window's own frame ----
        out_spatial = _attend(win_q, win_k, win_v)

        # ---- masked windows: full spatio-temporal attention ----
        sel = slice(None) if masked_windows is None else masked_windows
        frames = slice(None) if t_ind is None else torch.as_tensor(t_ind, device=x.device)

        def keys_of(t):  # window, rolled and pooled tokens of the masked windows
            eh, ew = (wh + 1) // 2, (ww + 1) // 2
            rolled = [_window_partition(torch.roll(t, (sh, sw), dims=(2, 3)),
                                        self.window_size, head)[:, sel][:, :, :, frames]
                      for sh, sw in ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))]
            rolled = torch.cat(rolled, dim=4)[:, :, :, :, self.valid_idx]
            win = _window_partition(t, self.window_size, head)[:, sel][:, :, :, frames]
            return torch.cat([win, rolled], dim=4)

        flat_x = x.reshape(B * T, Hp, Wp, C).permute(0, 3, 1, 2)
        pooled = F.conv2d(flat_x, self.pool_kernel, self.pool_bias, stride=self.pool_size,
                          groups=C)
        pooled = pooled.permute(0, 2, 3, 1).reshape(B, T, -1, C)
        n_pool = pooled.shape[2]

        def pooled_of(layer):  # [B, 1, head, T', n_pool, ch]
            p = layer(pooled).reshape(B, T, n_pool, head, C // head).permute(0, 3, 1, 2, 4)
            return p[:, :, frames][:, None]

        keys_t, vals_t = keys_of(k), keys_of(v)
        nM = keys_t.shape[1]
        pk, pv = pooled_of(self.key), pooled_of(self.value)
        keys_t = torch.cat([keys_t, pk.expand(-1, nM, -1, -1, -1, -1)], dim=4)
        vals_t = torch.cat([vals_t, pv.expand(-1, nM, -1, -1, -1, -1)], dim=4)
        n_tok = keys_t.shape[4]
        nk = keys_t.shape[3] * n_tok
        key_bias = None
        if frame_valid is not None:
            valid_t = frame_valid[:, frames]
            key_bias = torch.where(valid_t.repeat_interleave(n_tok, dim=1), 0.0, -1e9)
            key_bias = key_bias.float()[:, None, None, None, :]
        q_m = win_q[:, sel].reshape(B, nM, head, T * S, -1)
        out_masked = _attend(q_m, keys_t.reshape(B, nM, head, nk, -1),
                             vals_t.reshape(B, nM, head, nk, -1), key_bias)
        out_masked = out_masked.reshape(B, nM, head, T, S, -1)

        if masked_windows is not None:
            out = out_spatial.clone()
            out[:, masked_windows] = out_masked
        else:
            lt = mask.shape[1]
            mwin = mask.reshape(B, lt, nwh, wh, nww, ww)
            is_masked = mwin.amax(dim=(3, 5)).sum(dim=1).reshape(B, nwh * nww) > 0
            out = torch.where(is_masked[:, :, None, None, None, None], out_masked, out_spatial)

        out = out.reshape(B, nwh, nww, head, T, wh, ww, -1)
        out = out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, T, Hp, Wp, C)
        return self.proj(out[:, :, :H, :W])


class TemporalSparseTransformer(nn.Module):
    def __init__(self, dim: int = 512, n_head: int = 4, window_size=(5, 9), pool_size=(4, 4)):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)  # flax's default eps
        self.attention = SparseWindowAttention(dim, n_head, window_size, pool_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = FusionFeedForward(dim)

    def forward(self, x, fold_hw, mask, t_ind=None, frame_valid=None, masked_windows=None):
        x = x + self.attention(self.norm1(x), mask, t_ind, frame_valid, masked_windows)
        return x + self.mlp(self.norm2(x), fold_hw)


# ------------------------------------------------------------- generator

class ProPainterGenerator(nn.Module):
    def __init__(self, channel: int = 128, hidden: int = 512, depths: int = 8, n_head: int = 4,
                 window_size=(5, 9), pool_size=(4, 4)):
        super().__init__()
        self.channel, self.hidden, self.depths = channel, hidden, depths
        self.window_size = tuple(window_size)
        self.encoder = ProPainterEncoder(channel)
        self.ss = SoftSplit(channel, hidden)
        self.sc = SoftComp(channel, hidden)
        self.feat_prop_module = FeaturePropagation(channel)
        for i in range(depths):
            self.add_module(f"block{i}", TemporalSparseTransformer(
                hidden, n_head, window_size, pool_size))
        self.dec_deconv0 = _conv(channel, 128)
        self.dec_conv1 = _conv(128, 64)
        self.dec_deconv1 = _conv(64, 64)
        self.dec_conv2 = _conv(64, 3)

    @property
    def dtype(self) -> torch.dtype:
        return self.dec_conv2.weight.dtype

    def img_propagation(self, masked_frames, flows_f, flows_b, masks,
                        interpolation="nearest"):
        """The reference model's method name for ``image_propagation``."""
        return image_propagation(masked_frames, masks, flows_f, flows_b,
                                 interpolation)

    def decode(self, feat: torch.Tensor) -> torch.Tensor:
        x = _lrelu(self.dec_deconv0(upsample_bilinear_2x_align_corners(feat)))
        x = _lrelu(self.dec_conv1(x))
        x = _lrelu(self.dec_deconv1(upsample_bilinear_2x_align_corners(x)))
        return torch.tanh(self.dec_conv2(x))

    def encode(self, masked_frames, masks_in, masks_updated) -> torch.Tensor:
        """Per-frame encoding, window-independent: [B, T, 3+1+1, H, W] ->
        [B, T, channel, H/4, W/4]. A clip's frames are encoded once and each
        window gathers its rows (the reference re-encodes every window's
        frames, propainter.py:337)."""
        B, T, _, H, W = masked_frames.shape
        x = torch.cat([masked_frames, masks_in, masks_updated], dim=2)
        enc = self.encoder(x.reshape(B * T, 5, H, W).to(self.dtype))
        return enc.reshape(B, T, *enc.shape[1:])

    def forward(self, masked_frames, completed_flows, masks_in, masks_updated,
                num_local_frames: int, t_dilation: int = 2, frame_valid=None):
        """masked_frames [B, T, 3, H, W] in [-1, 1]; completed_flows
        ([B, lt-1, 2, H, W]) x 2; masks [B, T, 1, H, W] -> the local frames
        inpainted, [B, lt, 3, H, W] fp32."""
        enc = self.encode(masked_frames, masks_in, masks_updated)
        return self.forward_encoded(enc, completed_flows, masks_in, masks_updated,
                                    num_local_frames, t_dilation, frame_valid)

    def forward_encoded(self, enc, completed_flows, masks_in, masks_updated,
                        num_local_frames: int, t_dilation: int = 2, frame_valid=None,
                        masked_windows: Optional[torch.Tensor] = None):
        """The forward after the encoder: enc [B, T, channel, h, w] from
        encode(). masked_windows: the attention's hole-bearing window set
        for a mask that is the same in every frame (SparseWindowAttention)."""
        l_t = num_local_frames
        B, T, _, H, W = masks_in.shape
        h, w = enc.shape[-2:]
        dtype = self.dtype

        # 1/4-scale flows: torch F.interpolate(bilinear, align_corners=False)
        # samples 4i + 1.5 per axis, the mean of taps 1 and 2 of each 4-block
        def ds(f):
            a = (f[..., 1::4, :] + f[..., 2::4, :]) * 0.5
            return ((a[..., 1::4] + a[..., 2::4]) * 0.5 / 4.0).to(dtype)

        flows_f, flows_b = completed_flows
        ds_mask_in_local = masks_in[:, :l_t, :, ::4, ::4]
        ds_mask_updated_local = masks_updated[:, :l_t, :, ::4, ::4]
        # the hole mask of the token grid: a 7x7 stride-3 max pool (-inf padding)
        mask_pool = F.max_pool2d(ds_mask_in_local.reshape(B * l_t, 1, h, w), 7, 3, 3)
        mask_pool = mask_pool.reshape(B, l_t, *mask_pool.shape[-2:]).to(dtype)

        prop_mask = torch.cat([ds_mask_in_local, ds_mask_updated_local], dim=2).to(dtype)
        local_valid = frame_valid[:, :l_t] if frame_valid is not None else None
        local_feat = self.feat_prop_module(enc[:, :l_t], ds(flows_f), ds(flows_b), prop_mask,
                                           frame_valid=local_valid)
        enc = torch.cat([local_feat, enc[:, l_t:]], dim=1)

        tokens = self.ss(enc.reshape(B * T, self.channel, h, w))
        tokens = tokens.reshape(B, T, *tokens.shape[1:])
        t_inds = [np.arange(i, T, t_dilation) for i in range(t_dilation)]
        for i in range(self.depths):
            tokens = getattr(self, f"block{i}")(tokens, (h, w), mask_pool, t_inds[i % t_dilation],
                                                frame_valid, masked_windows)

        # soft-comp only the local tokens: the decoder reads no others
        comp = self.sc(tokens[:, :l_t].reshape(B * l_t, *tokens.shape[2:]), (h, w))
        local = enc[:, :l_t].reshape(B * l_t, self.channel, h, w) + comp
        return self.decode(local).reshape(B, l_t, 3, H, W).float()
