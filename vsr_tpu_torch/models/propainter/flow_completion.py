"""Recurrent flow-completion network (ProPainter's stage 2): counterpart of
``vsr_tpu/models/propainter/flow_completion.py`` (the reference's
recurrent_flow_completion.py:207-348).

A P3D encoder (Conv3d spatial 2x / 4x / 8x downsampling with temporal
convolutions of dilation 2), three dilated mid convolutions, second-order
deformable bidirectional propagation at 1/8 resolution, decoders with a
skip connection, and a bilinear-upsample head that predicts the completed
flow. The propagation sweeps are Python loops over time. Modules carry the
flax names (``enc1a.conv2``, ``prop.fusion``; flax's ``prop/backward`` is
``prop.backward_sweep``), so the JAX package's variables load through
``convert.from_flax.flow_completion_state_dict_from_flax``. The
training-only edge head (``EdgeDetector``, flax's ``edge``) is built with
``edge_head=True``; inference builds none and never calls it.

Video tensors are [B, T, C, H, W] (per-frame NCHW); the Conv3d layers see
[B, C, T, H, W]. The network computes in the dtype of its parameters and
returns fp32 flows.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.ops.deform_conv import modulated_deform_conv
from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners


def _lrelu(x: torch.Tensor, s: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, s)


class _Conv2d(nn.Module):
    """A 3x3 same-padding conv under flax's ``<name>/conv`` wrapper."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _Deconv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_bilinear_2x_align_corners(x))


class SecondOrderDeformableAlignment(nn.Module):
    """Deformable alignment of the stacked (prev1, prev2) features
    (recurrent_flow_completion.py:10-46): offsets are tanh-bounded residuals
    (bound 5.0) around each tap, with no flow term."""

    def __init__(self, channels: int, deform_groups: int = 16,
                 max_residue_magnitude: float = 5.0):
        super().__init__()
        c, G = channels, deform_groups
        self.G, self.bound = G, max_residue_magnitude
        self.off0 = _Conv2d(3 * c, c)
        self.off1 = _Conv2d(c, c)
        self.off2 = _Conv2d(c, c)
        self.off3 = _Conv2d(c, 27 * G)
        self.weight = nn.Parameter(torch.empty(c, 2 * c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, extra_feat: torch.Tensor) -> torch.Tensor:
        """x [B, 2C, H, W]; extra_feat [B, 3C, H, W] -> [B, C, H, W]."""
        feat = extra_feat
        for conv in (self.off0, self.off1, self.off2):
            feat = _lrelu(conv(feat), 0.1)
        out = self.off3(feat)
        B, _, H, W = out.shape
        G = self.G
        offset = self.bound * torch.tanh(out[:, :18 * G]).reshape(B, G, 9, 2, H, W)
        modulation = torch.sigmoid(out[:, 18 * G:]).reshape(B, G, 9, H, W)
        return modulated_deform_conv(x, offset, modulation, self.weight, self.bias)


class _SweepStep(nn.Module):
    """One time step's modules of a second-order propagation sweep."""

    def __init__(self, channels: int, n_inputs: int):
        super().__init__()
        self.align = SecondOrderDeformableAlignment(channels)
        self.bb1 = _Conv2d(n_inputs * channels, channels)
        self.bb2 = _Conv2d(channels, channels)


class FlowBidirectionalPropagation(nn.Module):
    """Second-order bidirectional propagation (recurrent_flow_completion.py:
    49-128): a backward sweep over the features, then a forward sweep that
    also reads the backward results, fused by a 1x1 conv, residual. The
    sweeps' flax names ``backward`` / ``forward`` are ``backward_sweep`` /
    ``forward_sweep`` here (``forward`` is nn.Module's method)."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.backward_sweep = _SweepStep(channels, 2)
        self.forward_sweep = _SweepStep(channels, 3)
        self.fusion = nn.Conv2d(2 * channels, channels, 1)

    def _sweep(self, step: _SweepStep, seq, others=None):
        """seq: list of [B, C, H, W] in sweep order -> list of outputs.
        The carry is (prev1, prev2), zeros at the start; the alignment
        output is zero at step 0, so it is not computed there."""
        n1 = n2 = torch.zeros_like(seq[0])
        outs = []
        for i, feat_current in enumerate(seq):
            if i == 0:
                feat_prop = torch.zeros_like(feat_current)
            else:
                feat_prop = step.align(torch.cat([n1, n2], dim=1),
                                       torch.cat([n1, feat_current, n2], dim=1))
            extra = [] if others is None else [others[i]]
            feat = torch.cat([feat_current] + extra + [feat_prop], dim=1)
            feat_prop = feat_prop + step.bb2(_lrelu(step.bb1(feat), 0.1))
            n1, n2 = feat_prop, n1
            outs.append(feat_prop)
        return outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C, H, W] -> [B, T, C, H, W]."""
        B, T, C, H, W = x.shape
        seq = list(x.unbind(1))
        backward = self._sweep(self.backward_sweep, seq[::-1])[::-1]
        forward = self._sweep(self.forward_sweep, seq, backward)
        both = torch.cat([torch.stack(backward, 1), torch.stack(forward, 1)], dim=2)
        fused = self.fusion(both.reshape(B * T, 2 * C, H, W))
        return fused.reshape(B, T, C, H, W) + x


class _P3DBlock(nn.Module):
    """(1,3,3) spatial conv (stride (1,s,s)), LeakyReLU, then a (3,1,1)
    temporal conv of dilation 2 and padding 2 (:157-166)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, features, (1, 3, 3), stride=(1, stride, stride),
                               padding=(0, 1, 1))
        self.conv2 = nn.Conv3d(features, features, (3, 1, 1), padding=(2, 0, 0),
                               dilation=(2, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(_lrelu(self.conv1(x)))


class EdgeDetector(nn.Module):
    """The flow-completion edge head (recurrent_flow_completion.py:176-204),
    trained against Canny edges of the flow: [N, 2, H, W] flow -> [N, 1, H,
    W] edge probability."""

    def __init__(self, mid: int = 16):
        super().__init__()
        self.proj = _Conv2d(2, mid)
        self.mid1 = _Conv2d(mid, mid)
        self.mid2 = _Conv2d(mid, mid)
        self.out = nn.Conv2d(mid, 1, 1)

    def forward(self, flow: torch.Tensor) -> torch.Tensor:
        x = _lrelu(self.proj(flow))
        e = self.mid2(_lrelu(self.mid1(x)))
        return torch.sigmoid(self.out(F.leaky_relu(x + e, 0.01)))


class RecurrentFlowCompleteNet(nn.Module):
    def __init__(self, edge_head: bool = False):
        super().__init__()
        self.down = nn.Conv3d(3, 32, (1, 5, 5), stride=(1, 2, 2))
        self.enc1a = _P3DBlock(32, 32, 1)
        self.enc1b = _P3DBlock(32, 64, 2)
        self.enc2a = _P3DBlock(64, 64, 1)
        self.enc2b = _P3DBlock(64, 128, 2)
        for i, dil in enumerate((3, 2, 1)):
            self.add_module(f"mid{i}", nn.Conv3d(128, 128, (1, 3, 3), padding=(0, dil, dil),
                                                 dilation=(1, dil, dil)))
        self.prop = FlowBidirectionalPropagation(128)
        self.dec2a = _Conv2d(128, 128)
        self.dec2b = _Deconv(128, 64)
        self.dec1a = _Conv2d(64, 64)
        self.dec1b = _Deconv(64, 32)
        self.upa = _Conv2d(32, 32)
        self.upb = _Deconv(32, 2)
        self.edge = EdgeDetector() if edge_head else None

    def forward(self, masked_flows: torch.Tensor, masks: torch.Tensor, train: bool = False):
        """masked_flows [B, T, 2, H, W]; masks [B, T, 1, H, W] -> completed
        flows [B, T, 2, H, W] fp32; with ``train``, also the edge head's
        [B*T, 1, H, W] edges (fp32) of those flows."""
        B, T, _, H, W = masked_flows.shape
        dtype = self.down.weight.dtype
        x = torch.cat([masked_flows, masks], dim=2).to(dtype).transpose(1, 2)  # [B, 3, T, H, W]
        # replicate padding of H and W only (the JAX package's mode="edge")
        x1 = _lrelu(self.down(F.pad(x, (2, 2, 2, 2, 0, 0), mode="replicate")))
        e1 = _lrelu(self.enc1b(_lrelu(self.enc1a(x1))))  # 4x
        e2 = _lrelu(self.enc2b(_lrelu(self.enc2a(e1))))  # 8x
        mid = e2
        for i in range(3):
            mid = _lrelu(getattr(self, f"mid{i}")(mid))
        prop = self.prop(mid.transpose(1, 2))  # [B, T, 128, h, w]

        def flat(v):  # [B, T, C, h, w] -> [B*T, C, h, w]
            return v.reshape(B * T, *v.shape[2:])

        d2 = _lrelu(self.dec2a(flat(prop)))
        d2 = _lrelu(self.dec2b(d2)) + flat(e1.transpose(1, 2))  # 4x
        d1 = _lrelu(self.dec1b(_lrelu(self.dec1a(d2))))  # 2x
        flow = self.upb(_lrelu(self.upa(d1)))
        flow = flow.reshape(B, T, 2, H, W).float()
        if train:
            if self.edge is None:
                raise ValueError("train=True needs the edge head: "
                                 "RecurrentFlowCompleteNet(edge_head=True)")
            return flow, self.edge(flow.reshape(B * T, 2, H, W).to(dtype)).float()
        return flow

    def forward_bidirect_flow(self, masked_flows_bi: Tuple[torch.Tensor, torch.Tensor],
                              masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """masked_flows_bi: (flows_f, flows_b), each [B, T-1, 2, H, W];
        masks [B, T, 1, H, W] (ref :314-339). The two directions are
        independent passes: one call runs both, stacked on the batch."""
        masks_forward, masks_backward = masks[:, :-1], masks[:, 1:]
        flows_f = masked_flows_bi[0] * (1 - masks_forward)
        flows_b = masked_flows_bi[1] * (1 - masks_backward)
        pred = self(torch.cat([flows_f, flows_b.flip(1)]),
                    torch.cat([masks_forward, masks_backward.flip(1)]))
        B = flows_f.shape[0]
        return pred[:B], pred[B:].flip(1)

    @staticmethod
    def combine_flow(masked_flows_bi, pred_flows_bi, masks):
        """The predictions inside the holes, the input flows elsewhere
        (ref :341-348)."""
        masks_forward, masks_backward = masks[:, :-1], masks[:, 1:]
        out_f = pred_flows_bi[0] * masks_forward + masked_flows_bi[0] * (1 - masks_forward)
        out_b = pred_flows_bi[1] * masks_backward + masked_flows_bi[1] * (1 - masks_backward)
        return out_f, out_b
