"""Plain reference of ProPainter (Zhou et al., ICCV 2023,
https://github.com/sczhou/ProPainter) with its RAFT flow network (Teed and
Deng, ECCV 2020, https://github.com/princeton-vl/RAFT), as the subtitle
remover's propainter mode runs them
(``backend/inpaint/propainter_inpaint.py`` of YaoFANGUK/video-subtitle-remover).

Written from the published sources (RAFT's ``core/raft.py``,
``extractor.py``, ``corr.py``, ``update.py``; ProPainter's
``model/propainter.py``, ``model/recurrent_flow_completion.py``,
``model/modules/sparse_transformer.py``, ``model/misc.py``) in float32
torch: plain convolutions, matmuls, softmax, ``F.grid_sample``, ``F.fold`` /
``F.unfold`` and ``F.interpolate``. It imports nothing of the program under
test. Module names follow the published checkpoints under one module, so
the benchmark's seeded state dict loads strictly: ``raft.`` holds
raft-things.pth (without DataParallel's ``module.``), ``flow_net.``
recurrent_flow_completion.pth and ``generator.`` ProPainter.pth.

``quant`` is applied to both operands of every convolution and matmul, as
in ``reference/sttn.py``: unchanged for the reference, rounded to float8
e4m3 under a per-tensor scale for the control.

The clip (``inpaint_clip``) follows the tool: frames in [-1, 1], the mask
dilated 4 times (4-connected) for both the flow mask and the frame mask;
RAFT flows of every consecutive pair both ways (20 iterations); flow
completion in sub-videos of ``subvideo_length`` flows with a 5-flow halo;
image propagation in chunks of min(100, ``subvideo_length``) frames with a
10-frame halo; then a window every ``neighbor_length // 2`` frames over
its neighbours and the global references of ``get_ref_index``, each
prediction truncated to uint8, composited under the mask and blended 0.5 /
0.5 with the earlier composite, truncated to uint8 after every window.

Departures from the published code, none of which changes what is
computed beyond float rounding:

* RAFT encodes every frame once and forms each pair from the encodings;
  upstream encodes both images of every pair in both directions. Its
  encoders work image by image (instance norm per image, batch norm in
  eval), so the features are the same. The 8x upsampled flow is formed
  after the last iteration only (upstream forms it every iteration and
  returns the last). Pairs run in chunks of ``pair_chunk`` (both
  directions together) to bound memory; the tool's chunks re-encode the
  frame before each chunk, and pairs are independent.
* The modulated deformable convolution (``torchvision.ops.deform_conv2d``
  upstream) is written here as a bilinear ``F.grid_sample`` of every tap
  (zeros outside), scaled by its modulation, then one matmul with the
  weight.
* The soft composition folds the local frames' tokens only; upstream folds
  every frame's and the decoder reads the local ones.
* Widths that upstream fixes are parameters, so tests can build narrow
  networks: RAFT's hidden and context widths, levels and radius; the
  generator's channel (its encoder widths scale with channel / 128, at
  least 8: at 128 they are upstream's), hidden width, depth, heads,
  window and pool sizes. The configuration's values are the published
  ones.
* No float16: upstream's tool runs the flow completion and the generator
  in half precision on a card; the comparison needs float32.
* ``dense``: every attention window runs the masked (spatio-temporal)
  branch, so that a count of work does not depend on the mask (the model
  FLOPs of ``counts_propainter.py``); the comparison never sets it.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.sttn import QUANTS, Quant


def conv(layer: nn.Module, x: torch.Tensor, q: Quant) -> torch.Tensor:
    """A Conv2d or Conv3d layer with ``q`` on its input and weight."""
    fn = F.conv3d if isinstance(layer, nn.Conv3d) else F.conv2d
    padding = layer.padding
    if layer.padding_mode != "zeros":
        x = F.pad(x, layer._reversed_padding_repeated_twice, mode=layer.padding_mode)
        padding = 0
    return fn(q(x), q(layer.weight), layer.bias, layer.stride, padding, layer.dilation,
              layer.groups)


def linear(layer: nn.Linear, x: torch.Tensor, q: Quant) -> torch.Tensor:
    return F.linear(q(x), q(layer.weight), layer.bias)


def seq(layers: nn.Sequential, x: torch.Tensor, q: Quant) -> torch.Tensor:
    """An nn.Sequential of convolutions, deconvs and activations, ``q`` on
    each convolution."""
    for layer in layers:
        if isinstance(layer, (nn.Conv2d, nn.Conv3d)):
            x = conv(layer, x, q)
        else:
            x = layer(x, q) if isinstance(layer, (deconv, P3DBlock)) else layer(x)
    return x


def grid_sample(img: torch.Tensor, grid: torch.Tensor, **kwargs) -> torch.Tensor:
    """F.grid_sample; the one sampler of the module (a count of work puts a
    shape-only stand-in here)."""
    return F.grid_sample(img, grid, **kwargs)


# ======================================================================= RAFT

class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        norm = nn.BatchNorm2d if norm_fn == "batch" else nn.InstanceNorm2d
        self.norm1, self.norm2 = norm(planes), norm(planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride),
                                            self.norm3)

    def forward(self, x, q):
        y = F.relu(self.norm1(conv(self.conv1, x, q)))
        y = F.relu(self.norm2(conv(self.conv2, y, q)))
        if self.downsample is not None:
            x = self.norm3(conv(self.downsample[0], x, q))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = nn.BatchNorm2d(64) if norm_fn == "batch" else nn.InstanceNorm2d(64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn), ResidualBlock(64, 64, norm_fn))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x, q):
        x = F.relu(self.norm1(conv(self.conv1, x, q)))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, q)
        return conv(self.conv2, x, q)


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, q):
        cor = F.relu(conv(self.convc2, F.relu(conv(self.convc1, corr, q)), q))
        flo = F.relu(conv(self.convf2, F.relu(conv(self.convf1, flow, q)), q))
        out = F.relu(conv(self.conv, torch.cat([cor, flo], dim=1), q))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h, x, q):
        for z_conv, r_conv, q_conv in ((self.convz1, self.convr1, self.convq1),
                                       (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(conv(z_conv, hx, q))
            r = torch.sigmoid(conv(r_conv, hx, q))
            qq = torch.tanh(conv(q_conv, torch.cat([r * h, x], dim=1), q))
            h = (1 - z) * h + z * qq
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x, q):
        return conv(self.conv2, F.relu(conv(self.conv1, x, q)), q)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cor_planes: int, hidden_dim: int, context_dim: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + context_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, q):
        motion = self.encoder(flow, corr, q)
        net = self.gru(net, torch.cat([inp, motion], dim=1), q)
        return net, 0.25 * seq(self.mask, net, q), self.flow_head(net, q)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """RAFT's sampler: ``coords`` [..., 2] in pixels (x, y), zeros outside."""
    H, W = img.shape[-2:]
    x, y = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1], dim=-1)
    return grid_sample(img, grid, align_corners=True)


class CorrBlock:
    """All-pairs correlation over sqrt(dim), a pyramid of 2x2 average pools,
    and a (2r+1)^2 bilinear window lookup on every level."""

    def __init__(self, fmap1, fmap2, num_levels: int, radius: int, q: Quant):
        self.num_levels, self.radius = num_levels, radius
        batch, dim, ht, wd = fmap1.shape
        corr = torch.matmul(q(fmap1.reshape(batch, dim, ht * wd).transpose(1, 2)),
                            q(fmap2.reshape(batch, dim, ht * wd)))
        corr = (corr / math.sqrt(dim)).reshape(batch * ht * wd, 1, ht, wd)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
        out = []
        for i, corr in enumerate(self.pyramid):
            centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(corr, centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2))
            out.append(sampled.view(batch, h1, w1, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).float()


@contextlib.contextmanager
def without_cudnn():
    """cuDNN off for a while, and back as it was. In float32 with TF32 off on
    an H100, cuDNN's heuristics take an FFT algorithm for one of RAFT's
    update convolutions at the cell's shapes, which launches ~66,000
    complex GEMMs a step: 235 s for a clip's flows against 10 s for
    PyTorch's own im2col and matmul. The result is the same convolution."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


class RAFT(nn.Module):
    def __init__(self, hidden: int = 128, context: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.hidden, self.context = hidden, context
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden + context, "batch")
        self.update_block = BasicUpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2, hidden,
                                             context)

    def encode(self, images, q):
        """Images [N, 3, H, W] in [-1, 1] -> (fmap, net, inp) at 1/8."""
        fmap = self.fnet(images, q).float()
        net, inp = torch.split(self.cnet(images, q), [self.hidden, self.context], dim=1)
        return fmap, torch.tanh(net), torch.relu(inp)

    @staticmethod
    def upsample_flow(flow, mask):
        N, _, H, W = flow.shape
        mask = torch.softmax(mask.view(N, 1, 9, 8, 8, H, W), dim=2)
        up = F.unfold(8 * flow, [3, 3], padding=1).view(N, 2, 9, 1, 1, H, W)
        up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
        return up.reshape(N, 2, 8 * H, 8 * W)

    def flow(self, fmap1, fmap2, net, inp, iters: int, q):
        """The flow from the first images to the second, [N, 2, H, W]. The
        update steps' convolutions run without cuDNN (see ``without_cudnn``)."""
        with without_cudnn():
            return self._flow(fmap1, fmap2, net, inp, iters, q)

    def _flow(self, fmap1, fmap2, net, inp, iters: int, q):
        corr_fn = CorrBlock(fmap1, fmap2, self.corr_levels, self.corr_radius, q)
        N, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=fmap1.device),
                                torch.arange(w, device=fmap1.device), indexing="ij")
        coords0 = torch.stack([xs, ys]).float()[None].repeat(N, 1, 1, 1)
        coords1 = coords0.clone()
        up_mask = None
        for _ in range(iters):
            corr = corr_fn(coords1)
            net, up_mask, delta = self.update_block(net, inp, corr, coords1 - coords0, q)
            coords1 = coords1 + delta
        return self.upsample_flow(coords1 - coords0, up_mask)

    def bi_flows(self, frames, iters: int, pair_chunk: int, q):
        """frames [T, 3, H, W] in [-1, 1] -> (flows_f, flows_b), [T-1, 2, H, W]
        each: flow t is frame t -> t+1, and t+1 -> t."""
        T = len(frames)
        enc = [self.encode(frames[s:s + 16], q) for s in range(0, T, 16)]
        fmap, net, inp = (torch.cat(parts) for parts in zip(*enc))
        del enc
        fw, bw = [], []
        for s in range(0, T - 1, pair_chunk):
            a = torch.arange(s, min(T - 1, s + pair_chunk), device=frames.device)
            b = a + 1
            flows = self.flow(torch.cat([fmap[a], fmap[b]]), torch.cat([fmap[b], fmap[a]]),
                              torch.cat([net[a], net[b]]), torch.cat([inp[a], inp[b]]), iters, q)
            fw.append(flows[:len(a)])
            bw.append(flows[len(a):])
        return torch.cat(fw), torch.cat(bw)


# ============================================================ shared blocks

def flow_warp(x, flow, interpolation: str = "bilinear"):
    """ProPainter's flow_warp: x [N, C, H, W] sampled at p + flow(p), flow
    [N, 2, H, W] with (x, y) channels; F.grid_sample with align_corners and
    zeros outside."""
    _, _, h, w = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                            torch.arange(w, device=flow.device), indexing="ij")
    grid = torch.stack((xs, ys), 2).to(x.dtype) + flow.permute(0, 2, 3, 1)
    gx = 2.0 * grid[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * grid[..., 1] / max(h - 1, 1) - 1.0
    return grid_sample(x, torch.stack((gx, gy), dim=3), mode=interpolation,
                         padding_mode="zeros", align_corners=True)


def fb_consistency_check(flow_fw, flow_bw, alpha1: float = 0.01, alpha2: float = 0.5):
    """1 where the forward flow and the warped backward flow agree."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    diff = flow_fw + flow_bw_warped
    mag_sq = (flow_fw ** 2).sum(1, keepdim=True) + (flow_bw_warped ** 2).sum(1, keepdim=True)
    return ((diff ** 2).sum(1, keepdim=True) < alpha1 * mag_sq + alpha2).to(flow_fw.dtype)


def deform_conv2d(x, offset, weight, bias, mask, q):
    """torchvision.ops.deform_conv2d at stride 1, padding 1, dilation 1 for a
    3x3 kernel: x [N, C, H, W]; offset [N, 2*G*9, H, W], (dy, dx) of tap k
    of group g at channels 18g + 2k, 18g + 2k + 1; mask [N, G*9, H, W];
    weight [Cout, C, 3, 3]. Every tap is a bilinear sample (zeros outside)
    at p + tap + offset, scaled by its mask, then one matmul."""
    N, C, H, W = x.shape
    cout = weight.shape[0]
    G = offset.shape[1] // 18
    cg = C // G
    off = offset.view(N, G, 9, 2, H, W)
    ys, xs = torch.meshgrid(torch.arange(H, device=x.device, dtype=x.dtype),
                            torch.arange(W, device=x.device, dtype=x.dtype), indexing="ij")
    taps = []
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        py = ys + ky + off[:, :, k, 0]  # [N, G, H, W]
        px = xs + kx + off[:, :, k, 1]
        grid = torch.stack((2 * px / max(W - 1, 1) - 1, 2 * py / max(H - 1, 1) - 1), dim=-1)
        sampled = grid_sample(x.view(N * G, cg, H, W), grid.view(N * G, H, W, 2),
                                align_corners=True)  # [N*G, cg, H, W]
        taps.append(sampled.view(N, G, cg, H, W) * mask.view(N, G, 9, H, W)[:, :, k, None])
    # [N, C (g, c), 9, H*W] -> columns in the weight's (c, kh, kw) order
    cols = torch.stack(taps, dim=3).reshape(N, C * 9, H * W)
    out = torch.matmul(q(weight.reshape(cout, C * 9)), q(cols)).view(N, cout, H, W)
    return out + bias.view(1, cout, 1, 1)


class ModulatedDeformConv2d(nn.Module):
    """The weight and bias of ProPainter's ModulatedDeformConv2d (3x3,
    stride 1, padding 1, 16 deformable groups)."""

    def __init__(self, in_channels: int, out_channels: int, deform_groups: int = 16):
        super().__init__()
        self.out_channels, self.deform_groups = out_channels, deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class deconv(nn.Module):  # noqa: N801 (upstream's name)
    """Bilinear 2x upsample (align_corners=True), then a convolution."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=1, padding=padding)

    def forward(self, x, q):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return conv(self.conv, x, q)


# ======================================================= flow completion

class SecondOrderDeformableAlignment(ModulatedDeformConv2d):
    def __init__(self, in_channels: int, out_channels: int, max_residue_magnitude: float = 5):
        super().__init__(in_channels, out_channels)
        self.max_residue_magnitude = max_residue_magnitude
        c = out_channels
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * self.deform_groups, 3, 1, 1))

    def forward(self, x, extra_feat, q):
        o1, o2, mask = torch.chunk(seq(self.conv_offset, extra_feat, q), 3, dim=1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat((o1, o2), dim=1))
        return deform_conv2d(x, offset, self.weight, self.bias, torch.sigmoid(mask), q)


class FlowPropagation(nn.Module):
    """recurrent_flow_completion.py's second-order BidirectionalPropagation."""

    def __init__(self, channel: int):
        super().__init__()
        self.channel = channel
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(("backward_", "forward_")):
            self.deform_align[name] = SecondOrderDeformableAlignment(2 * channel, channel)
            self.backbone[name] = nn.Sequential(
                nn.Conv2d((2 + i) * channel, channel, 3, 1, 1), nn.LeakyReLU(0.1),
                nn.Conv2d(channel, channel, 3, 1, 1))
        self.fusion = nn.Conv2d(2 * channel, channel, 1, 1, 0)

    def forward(self, x, q):
        """x [b, c, t, h, w] -> [b, c, t, h, w]."""
        b, c, t, h, w = x.shape
        feats = {"spatial": [x[:, :, i] for i in range(t)]}
        for name in ("backward_", "forward_"):
            feats[name] = []
            frame_idx = range(t)[::-1] if "backward" in name else range(t)
            feat_prop = x.new_zeros(b, self.channel, h, w)
            for i, idx in enumerate(frame_idx):
                feat_current = feats["spatial"][idx]
                if i > 0:
                    feat_n2 = feats[name][-2] if i > 1 else torch.zeros_like(feat_prop)
                    cond = torch.cat([feat_prop, feat_current, feat_n2], dim=1)
                    feat_prop = self.deform_align[name](torch.cat([feat_prop, feat_n2], dim=1),
                                                        cond, q)
                feat = [feat_current] + [feats[k][idx] for k in feats
                                         if k not in ("spatial", name)] + [feat_prop]
                feat_prop = feat_prop + seq(self.backbone[name], torch.cat(feat, dim=1), q)
                feats[name].append(feat_prop)
            if "backward" in name:
                feats[name] = feats[name][::-1]
        outputs = [conv(self.fusion, torch.cat([feats[k][i] for k in ("backward_", "forward_")],
                                               dim=1), q) for i in range(t)]
        return torch.stack(outputs, dim=2) + x


class P3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int, padding: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv3d(cin, cout, (1, kernel_size, kernel_size), stride=(1, stride, stride),
                      padding=(0, padding, padding)), nn.LeakyReLU(0.2))
        self.conv2 = nn.Sequential(
            nn.Conv3d(cout, cout, (3, 1, 1), stride=(1, 1, 1), padding=(2, 0, 0),
                      dilation=(2, 1, 1)))

    def forward(self, x, q):
        return seq(self.conv2, seq(self.conv1, x, q), q)


class EdgeDetection(nn.Module):
    """The training-only edge head; its weights are in the checkpoint, and
    inference never calls it."""

    def __init__(self, in_ch: int = 2, out_ch: int = 1, mid_ch: int = 16):
        super().__init__()
        self.projection = nn.Sequential(nn.Conv2d(in_ch, mid_ch, 3, 1, 1), nn.LeakyReLU(0.2))
        self.mid_layer_1 = nn.Sequential(nn.Conv2d(mid_ch, mid_ch, 3, 1, 1), nn.LeakyReLU(0.2))
        self.mid_layer_2 = nn.Sequential(nn.Conv2d(mid_ch, mid_ch, 3, 1, 1))
        self.out_layer = nn.Conv2d(mid_ch, out_ch, 1, 1, 0)


class RecurrentFlowCompleteNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.downsample = nn.Sequential(
            nn.Conv3d(3, 32, (1, 5, 5), stride=(1, 2, 2), padding=(0, 2, 2),
                      padding_mode="replicate"), nn.LeakyReLU(0.2))
        self.encoder1 = nn.Sequential(P3DBlock(32, 32, 3, 1, 1), nn.LeakyReLU(0.2),
                                      P3DBlock(32, 64, 3, 2, 1), nn.LeakyReLU(0.2))
        self.encoder2 = nn.Sequential(P3DBlock(64, 64, 3, 1, 1), nn.LeakyReLU(0.2),
                                      P3DBlock(64, 128, 3, 2, 1), nn.LeakyReLU(0.2))
        self.mid_dilation = nn.Sequential(
            nn.Conv3d(128, 128, (1, 3, 3), padding=(0, 3, 3), dilation=(1, 3, 3)),
            nn.LeakyReLU(0.2),
            nn.Conv3d(128, 128, (1, 3, 3), padding=(0, 2, 2), dilation=(1, 2, 2)),
            nn.LeakyReLU(0.2),
            nn.Conv3d(128, 128, (1, 3, 3), padding=(0, 1, 1), dilation=(1, 1, 1)),
            nn.LeakyReLU(0.2))
        self.feat_prop_module = FlowPropagation(128)
        self.decoder2 = nn.Sequential(nn.Conv2d(128, 128, 3, 1, 1), nn.LeakyReLU(0.2),
                                      deconv(128, 64, 3, 1), nn.LeakyReLU(0.2))
        self.decoder1 = nn.Sequential(nn.Conv2d(64, 64, 3, 1, 1), nn.LeakyReLU(0.2),
                                      deconv(64, 32, 3, 1), nn.LeakyReLU(0.2))
        self.upsample = nn.Sequential(nn.Conv2d(32, 32, 3, padding=1), nn.LeakyReLU(0.2),
                                      deconv(32, 2, 3, 1))
        self.edgeDetector = EdgeDetection(2, 1, 16)

    def forward(self, masked_flows, masks, q):
        """masked_flows [b, t, 2, h, w], masks [b, t, 1, h, w] -> flows."""
        b, t, _, h, w = masked_flows.shape
        x = torch.cat((masked_flows.permute(0, 2, 1, 3, 4), masks.permute(0, 2, 1, 3, 4)), dim=1)
        e1 = seq(self.encoder1, seq(self.downsample, x, q), q)  # [b, 64, t, h/4, w/4]
        mid = seq(self.mid_dilation, seq(self.encoder2, e1, q), q)
        prop = self.feat_prop_module(mid, q)  # [b, 128, t, h/8, w/8]

        def frames(v):  # [b, c, t, h', w'] -> [b*t, c, h', w']
            return v.permute(0, 2, 1, 3, 4).reshape(b * t, *v.shape[1:2], *v.shape[3:])

        d2 = seq(self.decoder2, frames(prop), q) + frames(e1)
        flow = seq(self.upsample, seq(self.decoder1, d2, q), q)
        return flow.view(b, t, 2, h, w)

    def forward_bidirect_flow(self, flows_bi, masks, q):
        """flows_bi ([b, t-1, 2, h, w] x 2), masks [b, t, 1, h, w]."""
        masks_f, masks_b = masks[:, :-1], masks[:, 1:]
        pred_f = self(flows_bi[0] * (1 - masks_f), masks_f, q)
        pred_b = self(torch.flip(flows_bi[1] * (1 - masks_b), dims=[1]),
                      torch.flip(masks_b, dims=[1]), q)
        return pred_f, torch.flip(pred_b, dims=[1])

    @staticmethod
    def combine_flow(flows_bi, pred_bi, masks):
        masks_f, masks_b = masks[:, :-1], masks[:, 1:]
        return (pred_bi[0] * masks_f + flows_bi[0] * (1 - masks_f),
                pred_bi[1] * masks_b + flows_bi[1] * (1 - masks_b))


# ================================================================ generator

class Encoder(nn.Module):
    def __init__(self, channel: int = 128):
        super().__init__()
        self.group = [1, 2, 4, 8, 1]

        def wd(base):  # upstream's widths at channel 128
            return max(8, int(base * channel / 128))

        skip = wd(256)
        widths = [(5, wd(64), 2, 1), (wd(64), wd(64), 1, 1), (wd(64), wd(128), 2, 1),
                  (wd(128), skip, 1, 1), (skip, wd(384), 1, 1), (skip + wd(384), wd(512), 1, 2),
                  (skip + wd(512), wd(384), 1, 4), (skip + wd(384), wd(256), 1, 8),
                  (skip + wd(256), channel, 1, 1)]
        layers = []
        for cin, cout, stride, groups in widths:
            layers += [nn.Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups),
                       nn.LeakyReLU(0.2)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x, q):
        bt = x.shape[0]
        out = x
        for i, layer in enumerate(self.layers):
            if i == 8:
                x0 = out
                _, _, h, w = x0.shape
            if i > 8 and i % 2 == 0:
                g = self.group[(i - 8) // 2]
                out = torch.cat([x0.view(bt, g, -1, h, w), out.view(bt, g, -1, h, w)],
                                2).view(bt, -1, h, w)
            out = conv(layer, out, q) if isinstance(layer, nn.Conv2d) else layer(out)
        return out


class DeformableAlignment(ModulatedDeformConv2d):
    def __init__(self, channels: int, max_residue_magnitude: float = 3):
        super().__init__(channels, channels)
        self.max_residue_magnitude = max_residue_magnitude
        c = channels
        self.conv_offset = nn.Sequential(
            nn.Conv2d(2 * c + 2 + 1 + 2, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * self.deform_groups, 3, 1, 1))

    def forward(self, x, cond_feat, flow, q):
        o1, o2, mask = torch.chunk(seq(self.conv_offset, cond_feat, q), 3, dim=1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat((o1, o2), dim=1))
        offset = offset + flow.flip(1).repeat(1, offset.size(1) // 2, 1, 1)
        return deform_conv2d(x, offset, self.weight, self.bias, torch.sigmoid(mask), q)


def binary_mask(mask, th: float = 0.1):
    return (mask > th).to(mask.dtype)


class BidirectionalPropagation(nn.Module):
    """propainter.py's propagation: learnable (features, with deformable
    alignment) or not (images, flow warps gated by the consistency check)."""

    def __init__(self, channel: int, learnable: bool = True):
        super().__init__()
        self.channel, self.learnable = channel, learnable
        if learnable:
            self.deform_align = nn.ModuleDict()
            self.backbone = nn.ModuleDict()
            for name in ("backward_1", "forward_1"):
                self.deform_align[name] = DeformableAlignment(channel)
                self.backbone[name] = nn.Sequential(
                    nn.Conv2d(2 * channel + 2, channel, 3, 1, 1), nn.LeakyReLU(0.2),
                    nn.Conv2d(channel, channel, 3, 1, 1))
            self.fuse = nn.Sequential(
                nn.Conv2d(2 * channel + 2, channel, 3, 1, 1), nn.LeakyReLU(0.2),
                nn.Conv2d(channel, channel, 3, 1, 1))

    def forward(self, x, flows_forward, flows_backward, mask, interpolation="bilinear",
                q: Quant = QUANTS["float32"]):
        """x [b, t, c, h, w], flows [b, t-1, 2, h, w], mask [b, t, m, h, w] ->
        (backward, forward, output, forward masks or None)."""
        b, t, c, h, w = x.shape
        feats = {"input": [x[:, i] for i in range(t)]}
        masks = {"input": [mask[:, i] for i in range(t)]}
        cache = ["input", "backward_1", "forward_1"]
        for p, name in enumerate(cache[1:]):
            feats[name], masks[name] = [], []
            if "backward" in name:
                frame_idx = list(range(t))[::-1]
                flow_idx = frame_idx
                flows_prop, flows_check = flows_forward, flows_backward
            else:
                frame_idx = list(range(t))
                flow_idx = list(range(-1, t - 1))
                flows_prop, flows_check = flows_backward, flows_forward
            for i, idx in enumerate(frame_idx):
                feat_current = feats[cache[p]][idx]
                mask_current = masks[cache[p]][idx]
                if i == 0:
                    feat_prop, mask_prop = feat_current, mask_current
                else:
                    flow_prop = flows_prop[:, flow_idx[i]]
                    flow_check = flows_check[:, flow_idx[i]]
                    valid = fb_consistency_check(flow_prop, flow_check)
                    feat_warped = flow_warp(feat_prop, flow_prop, interpolation)
                    if self.learnable:
                        cond = torch.cat([feat_current, feat_warped, flow_prop, valid,
                                          mask_current], dim=1)
                        feat_prop = self.deform_align[name](feat_prop, cond, flow_prop, q)
                        mask_prop = mask_current
                    else:
                        mask_prop_valid = binary_mask(flow_warp(mask_prop, flow_prop))
                        union = binary_mask(mask_current * valid * (1 - mask_prop_valid))
                        feat_prop = union * feat_warped + (1 - union) * feat_current
                        mask_prop = binary_mask(mask_current * (1 - valid * (1 - mask_prop_valid)))
                if self.learnable:
                    feat = torch.cat([feat_current, feat_prop, mask_current], dim=1)
                    feat_prop = feat_prop + seq(self.backbone[name], feat, q)
                feats[name].append(feat_prop)
                masks[name].append(mask_prop)
            if "backward" in name:
                feats[name], masks[name] = feats[name][::-1], masks[name][::-1]
        out_b = torch.stack(feats["backward_1"], dim=1).view(-1, c, h, w)
        out_f = torch.stack(feats["forward_1"], dim=1).view(-1, c, h, w)
        if self.learnable:
            fused = seq(self.fuse, torch.cat([out_b, out_f, mask.view(-1, 2, h, w)], dim=1), q)
            return out_b, out_f, (fused + x.view(-1, c, h, w)).view(b, t, c, h, w), None
        return out_b, out_f, out_f.view(b, t, c, h, w), torch.stack(masks["forward_1"], dim=1)


class SoftSplit(nn.Module):
    def __init__(self, channel: int, hidden: int, kernel, stride, padding):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.embedding = nn.Linear(kernel[0] * kernel[1] * channel, hidden)

    def forward(self, x, b, q):
        """x [b*t, c, h, w] -> tokens [b, t, fh, fw, hidden]."""
        h, w = x.shape[-2:]
        fh = (h + 2 * self.padding[0] - (self.kernel[0] - 1) - 1) // self.stride[0] + 1
        fw = (w + 2 * self.padding[1] - (self.kernel[1] - 1) - 1) // self.stride[1] + 1
        feat = F.unfold(x, self.kernel, stride=self.stride, padding=self.padding)
        feat = linear(self.embedding, feat.permute(0, 2, 1), q)
        return feat.view(b, -1, fh, fw, feat.size(2))


class SoftComp(nn.Module):
    def __init__(self, channel: int, hidden: int, kernel, stride, padding):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.embedding = nn.Linear(hidden, kernel[0] * kernel[1] * channel)
        self.bias_conv = nn.Conv2d(channel, channel, 3, 1, 1)

    def forward(self, x, t, output_size, q):
        """tokens [b, t, fh, fw, hidden] -> [b*t, c, h, w]."""
        b = x.shape[0]
        feat = linear(self.embedding, x.reshape(b, -1, x.shape[-1]), q)
        feat = feat.view(b * t, -1, feat.shape[-1]).permute(0, 2, 1)
        feat = F.fold(feat, output_size, self.kernel, stride=self.stride, padding=self.padding)
        return conv(self.bias_conv, feat, q)


class FusionFeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, kernel, stride, padding):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.fc1 = nn.Sequential(nn.Linear(dim, hidden_dim))
        self.fc2 = nn.Sequential(nn.GELU(), nn.Linear(hidden_dim, dim))

    def forward(self, x, output_size, q):
        n_vecs = 1
        for i, k in enumerate(self.kernel):
            n_vecs *= (output_size[i] + 2 * self.padding[i] - (k - 1) - 1) // self.stride[i] + 1
        x = linear(self.fc1[0], x, q)
        b, n, c = x.shape
        kk = self.kernel[0] * self.kernel[1]
        normalizer = x.new_ones(b, n, kk).view(-1, n_vecs, kk).permute(0, 2, 1)
        fold = dict(kernel_size=self.kernel, padding=self.padding, stride=self.stride)
        normalizer = F.fold(normalizer, output_size, **fold)
        x = F.fold(x.view(-1, n_vecs, c).permute(0, 2, 1), output_size, **fold)
        x = F.unfold(x / normalizer, **fold).permute(0, 2, 1).contiguous().view(b, n, c)
        return linear(self.fc2[1], F.gelu(x), q)


def window_partition(x, window_size, n_head):
    """[B, T, H, W, C] -> [B, nH, nW, head, T, wh, ww, C/head]."""
    B, T, H, W, C = x.shape
    x = x.view(B, T, H // window_size[0], window_size[0], W // window_size[1], window_size[1],
               n_head, C // n_head)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).contiguous()


class SparseWindowAttention(nn.Module):
    def __init__(self, dim: int, n_head: int, window_size, pool_size):
        super().__init__()
        self.key = nn.Linear(dim, dim)
        self.query = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.n_head, self.window_size = n_head, tuple(window_size)
        self.pool_layer = nn.Conv2d(dim, dim, pool_size, stride=pool_size, padding=(0, 0),
                                    groups=dim)
        self.expand_size = tuple((i + 1) // 2 for i in self.window_size)
        eh, ew = self.expand_size
        wh, ww = self.window_size
        masks = np.ones((4, wh, ww), np.int64)
        for m, rows, cols in zip(masks, (slice(None, -eh), slice(None, -eh), slice(eh, None),
                                         slice(eh, None)),
                                 (slice(None, -ew), slice(ew, None), slice(None, -ew),
                                  slice(ew, None))):
            m[rows, cols] = 0
        # the tokens of the four rolled windows that are keys (numpy, so that
        # the module builds on the meta device too)
        self.register_buffer("valid_ind_rolled", torch.from_numpy(np.flatnonzero(masks)))
        self.max_pool = nn.MaxPool2d(self.window_size, self.window_size, (0, 0))

    def forward(self, x, mask, T_ind, q, dense: bool = False):  # noqa: N803 (upstream's name)
        """x [b, t, h, w, c]; mask [b, l_t, h, w, 1] (the pooled hole mask of
        the local frames); T_ind: the frames the masked windows' keys come
        from."""
        b, t, h, w, c = x.shape
        wh, ww = self.window_size
        head = self.n_head
        c_head = c // head
        n_wh, n_ww = math.ceil(h / wh), math.ceil(w / ww)
        new_h, new_w = n_wh * wh, n_ww * ww
        pad_r, pad_b = new_w - w, new_h - h
        if pad_r > 0 or pad_b > 0:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, 0))
            mask = F.pad(mask, (0, 0, 0, pad_r, 0, pad_b, 0, 0))
        qq, k, v = (linear(m, x, q) for m in (self.query, self.key, self.value))
        nw, S = n_wh * n_ww, wh * ww

        def windows(a):
            return window_partition(a.contiguous(), self.window_size, head).view(
                b, nw, head, t, S, c_head)

        win_q, win_k, win_v = windows(qq), windows(k), windows(v)
        eh, ew = self.expand_size
        rolled = []
        for a in (k, v):
            parts = [windows(torch.roll(a, shifts=s, dims=(2, 3)))
                     for s in ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))]
            rolled.append(torch.cat(parts, 4)[:, :, :, :, self.valid_ind_rolled])
        pool_x = conv(self.pool_layer, x.view(b * t, new_h, new_w, c).permute(0, 3, 1, 2), q)
        _, _, p_h, p_w = pool_x.shape
        pool_x = pool_x.permute(0, 2, 3, 1).reshape(b, t, p_h, p_w, c)
        pooled = []
        for m in (self.key, self.value):
            p = linear(m, pool_x, q).unsqueeze(1).repeat(1, nw, 1, 1, 1, 1)
            p = p.view(b, nw, t, p_h, p_w, head, c_head).permute(0, 1, 5, 2, 3, 4, 6)
            pooled.append(p.contiguous().view(b, nw, head, t, p_h * p_w, c_head))
        keys = torch.cat((win_k, rolled[0], pooled[0]), dim=4)
        values = torch.cat((win_v, rolled[1], pooled[1]), dim=4)

        out = torch.zeros_like(win_q)
        l_t = mask.size(1)
        mask = self.max_pool(mask.reshape(b * l_t, new_h, new_w))
        mask = torch.sum(mask.view(b, l_t, nw), dim=1)
        scale = 1.0 / math.sqrt(c_head)
        for i in range(b):
            masked = (torch.arange(nw, device=x.device) if dense
                      else mask[i].nonzero(as_tuple=False).view(-1))
            n = len(masked)
            if n > 0:
                kt = keys[i, masked][:, :, T_ind.view(-1)].reshape(n, head, -1, c_head)
                vt = values[i, masked][:, :, T_ind.view(-1)].reshape(n, head, -1, c_head)
                att = torch.matmul(q(win_q[i, masked].view(n, head, t * S, c_head)),
                                   q(kt).transpose(-2, -1)) * scale
                y = torch.matmul(q(F.softmax(att, dim=-1)), q(vt))
                out[i, masked] = y.view(n, head, t, S, c_head)
            if dense:
                continue
            rest = (mask[i] == 0).nonzero(as_tuple=False).view(-1)
            att = torch.matmul(q(win_q[i, rest]), q(win_k[i, rest]).transpose(-2, -1)) * scale
            out[i, rest] = torch.matmul(q(F.softmax(att, dim=-1)), q(win_v[i, rest]))
        out = out.view(b, n_wh, n_ww, head, t, wh, ww, c_head)
        out = out.permute(0, 4, 1, 5, 2, 6, 3, 7).contiguous().view(b, t, new_h, new_w, c)
        return linear(self.proj, out[:, :, :h, :w], q)


class TemporalSparseTransformer(nn.Module):
    def __init__(self, dim: int, n_head: int, window_size, pool_size, t2t):
        super().__init__()
        self.attention = SparseWindowAttention(dim, n_head, window_size, pool_size)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = FusionFeedForward(dim, 1960, **t2t)

    def forward(self, x, fold_size, mask, T_ind, q, dense=False):  # noqa: N803
        B, T, H, W, C = x.shape
        x = x + self.attention(self.norm1(x), mask, T_ind, q, dense)
        y = self.mlp(self.norm2(x).view(B, T * H * W, C), fold_size, q)
        return x + y.view(B, T, H, W, C)


class TemporalSparseTransformerBlock(nn.Module):
    def __init__(self, dim, n_head, window_size, pool_size, depths, t2t):
        super().__init__()
        self.depths = depths
        self.transformer = nn.Sequential(*[
            TemporalSparseTransformer(dim, n_head, window_size, pool_size, t2t)
            for _ in range(depths)])

    def forward(self, x, fold_size, mask, q, t_dilation=2, dense=False):
        T = x.size(1)
        T_ind = [torch.arange(i, T, t_dilation, device=x.device)
                 for i in range(t_dilation)] * (self.depths // t_dilation)
        for i in range(self.depths):
            x = self.transformer[i](x, fold_size, mask, T_ind[i], q, dense)
        return x


class InpaintGenerator(nn.Module):
    def __init__(self, channel: int = 128, hidden: int = 512, depths: int = 8, heads: int = 4,
                 window_size=(5, 9), pool_size=(4, 4), kernel=(7, 7), stride=(3, 3),
                 padding=(3, 3)):
        super().__init__()
        self.channel = channel
        self.encoder = Encoder(channel)
        self.decoder = nn.Sequential(
            deconv(channel, 128, 3, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(128, 64, 3, 1, 1), nn.LeakyReLU(0.2),
            deconv(64, 64, 3, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 3, 3, 1, 1))
        t2t = dict(kernel=tuple(kernel), stride=tuple(stride), padding=tuple(padding))
        self.ss = SoftSplit(channel, hidden, **t2t)
        self.sc = SoftComp(channel, hidden, **t2t)
        self.max_pool = nn.MaxPool2d(tuple(kernel), tuple(stride), tuple(padding))
        self.img_prop_module = BidirectionalPropagation(3, learnable=False)
        self.feat_prop_module = BidirectionalPropagation(channel, learnable=True)
        self.transformers = TemporalSparseTransformerBlock(hidden, heads, window_size, pool_size,
                                                           depths, t2t)

    def encode(self, masked_frames, masks_in, masks_updated, q):
        """[b, t, 3 | 1 | 1, H, W] -> [b*t, c, H/4, W/4]."""
        b, t, _, H, W = masked_frames.shape
        return self.encoder(torch.cat([masked_frames.view(b * t, 3, H, W),
                                       masks_in.view(b * t, 1, H, W),
                                       masks_updated.view(b * t, 1, H, W)], dim=1), q)

    def forward(self, masked_frames, completed_flows, masks_in, masks_updated,
                num_local_frames, q, dense=False):
        """One window: [b, t, ...] in -> the local frames' prediction
        [b, l_t, 3, H, W] in [-1, 1]."""
        return self.forward_encoded(self.encode(masked_frames, masks_in, masks_updated, q),
                                    completed_flows, masks_in, masks_updated, num_local_frames,
                                    q, dense)

    def forward_encoded(self, enc_feat, completed_flows, masks_in, masks_updated,
                        num_local_frames, q, dense=False, logits=False):
        """The window after the encoder; ``logits``: the decoder's output
        before the tanh."""
        l_t = num_local_frames
        b, t, _, ori_h, ori_w = masks_in.shape
        _, c, h, w = enc_feat.shape
        local_feat = enc_feat.view(b, t, c, h, w)[:, :l_t]
        ref_feat = enc_feat.view(b, t, c, h, w)[:, l_t:]

        def ds_flow(f):
            small = F.interpolate(f.reshape(-1, 2, ori_h, ori_w), scale_factor=1 / 4,
                                  mode="bilinear", align_corners=False)
            return small.view(b, l_t - 1, 2, h, w) / 4.0

        ds_flows_f, ds_flows_b = ds_flow(completed_flows[0]), ds_flow(completed_flows[1])
        ds_mask_in = F.interpolate(masks_in.reshape(-1, 1, ori_h, ori_w), scale_factor=1 / 4,
                                   mode="nearest").view(b, t, 1, h, w)
        ds_mask_in_local = ds_mask_in[:, :l_t]
        ds_mask_updated_local = F.interpolate(
            masks_updated[:, :l_t].reshape(-1, 1, ori_h, ori_w), scale_factor=1 / 4,
            mode="nearest").view(b, l_t, 1, h, w)
        mask_pool_l = self.max_pool(ds_mask_in_local.reshape(-1, 1, h, w))
        mask_pool_l = mask_pool_l.view(b, l_t, 1, *mask_pool_l.shape[-2:])
        prop_mask_in = torch.cat([ds_mask_in_local, ds_mask_updated_local], dim=2)
        _, _, local_feat, _ = self.feat_prop_module(local_feat, ds_flows_f, ds_flows_b,
                                                    prop_mask_in, "bilinear", q)
        enc_feat = torch.cat((local_feat, ref_feat), dim=1)
        trans_feat = self.ss(enc_feat.reshape(-1, c, h, w), b, q)
        mask_pool_l = mask_pool_l.permute(0, 1, 3, 4, 2).contiguous()  # b t h w c
        trans_feat = self.transformers(trans_feat, (h, w), mask_pool_l, q, 2, dense)
        trans_feat = self.sc(trans_feat[:, :l_t], l_t, (h, w), q).view(b, l_t, c, h, w)
        local = enc_feat[:, :l_t] + trans_feat
        x = seq(self.decoder, local.reshape(-1, c, h, w), q).view(b, l_t, 3, ori_h, ori_w)
        return x if logits else torch.tanh(x)

    def img_propagation(self, masked_frames, completed_flows, masks, interpolation="nearest"):
        _, _, prop_frames, updated_masks = self.img_prop_module(
            masked_frames, completed_flows[0], completed_flows[1], masks, interpolation)
        return prop_frames, updated_masks


# ================================================================ the clip

class ProPainter(nn.Module):
    """The three networks under one module, named as their checkpoints."""

    def __init__(self, cfg: dict, quant: str = "float32"):
        super().__init__()
        self.q = QUANTS[quant]
        r, g = cfg["raft"], cfg["generator"]
        self.raft = RAFT(r["hidden"], r["context"], r["corr_levels"], r["corr_radius"])
        self.flow_net = RecurrentFlowCompleteNet()
        self.generator = InpaintGenerator(
            g["channel"], g["hidden"], g["depths"], g["heads"], g["window_size"],
            g["pool_size"], g["soft_split"]["kernel"], g["soft_split"]["stride"],
            g["soft_split"]["padding"])


def get_ref_index(mid, neighbor_ids, length, ref_stride=10, ref_num=-1):
    """The tool's global references."""
    ref_index = []
    if ref_num == -1:
        for i in range(0, length, ref_stride):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start_idx = max(0, mid - ref_stride * (ref_num // 2))
        end_idx = min(length, mid + ref_stride * (ref_num // 2))
        for i in range(start_idx, end_idx, ref_stride):
            if i not in neighbor_ids:
                if len(ref_index) > ref_num:
                    break
                ref_index.append(i)
    return ref_index


def clip_windows(T: int, cfg: dict) -> List[Tuple[List[int], List[int]]]:
    """(neighbour ids, reference ids) of each window of a T-frame clip."""
    stride = cfg["neighbor_length"] // 2
    ref_num = cfg["subvideo_length"] // cfg["ref_stride"] if T > cfg["subvideo_length"] else -1
    out = []
    for f in range(0, T, stride):
        nbrs = list(range(max(0, f - stride), min(T, f + stride + 1)))
        out.append((nbrs, get_ref_index(f, nbrs, T, cfg["ref_stride"], ref_num)))
    return out


def dilate(mask01: np.ndarray, iterations: int) -> np.ndarray:
    """Binary dilation with the 4-connected cross (scipy's default), zeros
    beyond the border."""
    m = np.asarray(mask01) > 0
    for _ in range(iterations):
        grown = m.copy()
        grown[1:] |= m[:-1]
        grown[:-1] |= m[1:]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        m = grown
    return m


def _halo(length: int, sub: int, pad: int):
    """(start, end, keep from, keep to) of the tool's chunks with a halo."""
    for f in range(0, length, sub):
        s, e = max(0, f - pad), min(length, f + sub + pad)
        yield s, e, f - s, e - s - (e - min(length, f + sub))


@torch.no_grad()
def complete_flows(model: ProPainter, flows, masks, cfg: dict):
    """The tool's flow completion: flows ([1, T-1, 2, h, w]) x 2, masks [1, T,
    1, h, w] -> the completed flows, in sub-videos of ``subvideo_length``
    flows with a 5-flow halo."""
    q, net = model.q, model.flow_net
    n, sub = flows[0].shape[1], cfg["subvideo_length"]
    if n <= sub:
        return net.combine_flow(flows, net.forward_bidirect_flow(flows, masks, q), masks)
    pf, pb = [], []
    for s, e, k0, k1 in _halo(n, sub, 5):
        part = (flows[0][:, s:e], flows[1][:, s:e])
        pred = net.combine_flow(part, net.forward_bidirect_flow(part, masks[:, s:e + 1], q),
                                masks[:, s:e + 1])
        pf.append(pred[0][:, k0:k1])
        pb.append(pred[1][:, k0:k1])
    return torch.cat(pf, 1), torch.cat(pb, 1)


@torch.no_grad()
def propagate_images(model: ProPainter, frames, masks, completed, cfg: dict):
    """The tool's image propagation: frames [1, T, 3, h, w] in [-1, 1], masks
    [1, T, 1, h, w], the completed flows -> (the frames with the propagated
    pixels in the holes, the masks still to fill), in chunks of min(100,
    ``subvideo_length``) frames with a 10-frame halo."""
    T, h, w = frames.shape[1], frames.shape[-2], frames.shape[-1]
    masked = frames * (1 - masks)
    gen, sub = model.generator, min(100, cfg["subvideo_length"])
    spans = list(_halo(T, sub, 10)) if T > sub else [(0, T, 0, T)]
    upd_f, upd_m = [], []
    for s, e, k0, k1 in spans:
        prop, upd = gen.img_propagation(masked[:, s:e], (completed[0][:, s:e - 1],
                                                         completed[1][:, s:e - 1]),
                                        masks[:, s:e], "nearest")
        f = frames[:, s:e] * (1 - masks[:, s:e]) + prop.view(1, e - s, 3, h, w) * masks[:, s:e]
        upd_f.append(f[:, k0:k1])
        upd_m.append(upd.view(1, e - s, 1, h, w)[:, k0:k1])
    return torch.cat(upd_f, 1), torch.cat(upd_m, 1)


@torch.no_grad()
def clip_stages(model: ProPainter, frames_rgb: torch.Tensor, hole: torch.Tensor, cfg: dict):
    """The stages before the window sweep: frames_rgb [T, 3, h, w] uint8 RGB,
    hole [h, w] {0, 1} float (dilated) -> (frames in [-1, 1], masks
    [1, T, 1, h, w], the RAFT flows, the completed flows, each ([1, T-1, 2,
    h, w]) x 2, the propagated frames and the masks still to fill)."""
    T, _, h, w = frames_rgb.shape
    frames = frames_rgb.float()[None] / 255.0 * 2 - 1
    masks = hole[None, None, None].expand(1, T, 1, h, w)
    flows_f, flows_b = model.raft.bi_flows(frames[0], cfg["raft"]["iters"],
                                           cfg["reference_pair_chunk"], model.q)
    flows = (flows_f[None], flows_b[None])
    completed = complete_flows(model, flows, masks, cfg)
    updated, updated_masks = propagate_images(model, frames, masks, completed, cfg)
    return frames, masks, flows, completed, updated, updated_masks


@torch.no_grad()
def inpaint_clip(model: ProPainter, frames_bgr: torch.Tensor, hole: torch.Tensor,
                 cfg: dict) -> torch.Tensor:
    """frames_bgr [T, h, w, 3] uint8, hole [h, w] {0, 1} float (dilated) ->
    the composited frames, uint8 BGR [T, h, w, 3]."""
    rgb = frames_bgr.flip(-1).permute(0, 3, 1, 2).contiguous()
    T = len(rgb)
    _, masks, _, completed, updated, updated_masks = clip_stages(model, rgb, hole, cfg)
    binary = hole.to(torch.uint8)[None]  # [1, h, w]
    comp: List[Optional[torch.Tensor]] = [None] * T
    for nbrs, refs in clip_windows(T, cfg):
        ids = nbrs + refs
        pair = nbrs[:-1]
        pred = model.generator(updated[:, ids], (completed[0][:, pair], completed[1][:, pair]),
                               masks[:, ids], updated_masks[:, ids], len(nbrs), model.q)[0]
        pred = ((pred + 1) / 2 * 255).clamp(0, 255).to(torch.uint8)
        for j, idx in enumerate(nbrs):
            img = pred[j] * binary + rgb[idx] * (1 - binary)
            if comp[idx] is not None:
                img = (comp[idx].float() * 0.5 + img.float() * 0.5).to(torch.uint8)
            comp[idx] = img
    return torch.stack(comp).permute(0, 2, 3, 1).flip(-1)


def band_rows(mask01: np.ndarray, band_h: int) -> Tuple[int, int]:
    """The tool's band for a mask of one connected region (see
    ``pipeline.band_of``); the sides must be multiples of 8, as the cell's
    and the tests' are."""
    from perfbench.reference.pipeline import band_of

    ymin, ymax = band_of(mask01, band_h)
    if (ymax - ymin) % 8 or mask01.shape[1] % 8:
        raise ValueError("the reference takes bands whose sides are multiples of 8")
    return ymin, ymax


@torch.no_grad()
def propainter(model: ProPainter, frames: Sequence[np.ndarray], mask: np.ndarray, cfg: dict,
               device) -> Tuple[torch.Tensor, np.ndarray]:
    """One clip of full-size BGR frames under a uint8 mask (0 / 255) -> (the
    frames a user gets back, uint8 [n, H, W, 3] on ``device``; the region
    the tool repaints, the dilated mask inside the band, [H, W] bool)."""
    mask01 = (mask > 127).astype(np.uint8)
    H, W = mask01.shape
    num, den = cfg["band_height_of_width"]
    ymin, ymax = band_rows(mask01, W * num // den)
    hole = dilate(mask01[ymin:ymax], cfg["mask_dilation"])
    full = torch.from_numpy(np.stack(frames)).to(device)
    comp = inpaint_clip(model, full[:, ymin:ymax].contiguous(),
                        torch.from_numpy(hole.astype(np.float32)).to(device), cfg)
    out = full.clone()
    out[:, ymin:ymax] = comp
    region = np.zeros((H, W), bool)
    region[ymin:ymax] = hole
    return out, region
