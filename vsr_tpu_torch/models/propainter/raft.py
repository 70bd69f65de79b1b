"""RAFT optical flow (the things checkpoint's configuration): counterpart of
``vsr_tpu/models/propainter/raft.py`` (the reference's raft/raft.py:24-146,
extractor.py, corr.py, update.py).

BasicEncoder feature and context networks (instance norm and batch norm,
both eps 1e-5), a 4-level all-pairs correlation pyramid with a radius-4
bilinear window lookup, a SepConvGRU update block iterated ``iters`` times,
and convex 8x upsampling of the flow. Modules carry the flax names
(``fnet.layer2.down``, ``cnet.norm1.bn``, ``step.update.gru.convz1``), so
the JAX package's variables load through
``convert.from_flax.raft_state_dict_from_flax``.

Images are NCHW in [-1, 1], H and W multiples of 8; flows are [B, 2, H, W]
with (x, y) channels. The network runs in the dtype of its parameters; the
pyramid and the coordinates are fp32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ENCODE_CHUNK = 16  # frames a RAFT / generator encoder call takes


class _Norm(nn.Module):
    """Instance norm (fnet) or eval-mode batch norm (cnet), eps 1e-5."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.bn = nn.BatchNorm2d(channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "instance":  # affine-free, biased variance
            return F.instance_norm(x, eps=1e-5)
        return self.bn(x)


class _ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _Norm(norm, planes)
        self.norm2 = _Norm(norm, planes)
        self.down = None
        if stride != 1 or cin != planes:
            self.down = nn.Conv2d(cin, planes, 1, stride=stride)
            self.norm3 = _Norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.down is not None:
            x = self.norm3(self.down(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _Norm(norm, 64)
        layers, cin = [], 64
        for planes, stride in [(64, 1), (64, 1), (96, 2), (96, 1), (128, 2), (128, 1)]:
            layers.append(_ResidualBlock(cin, planes, norm, stride))
            cin = planes
        for i, layer in enumerate(layers):
            self.add_module(f"layer{i}", layer)
        self.n_layers = len(layers)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x)
        return self.conv2(x)


# ---- correlation pyramid ----

def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """fmap* [B, C, h, w] -> num_levels fp32 volumes [B*h*w, h_l, w_l]: all
    pairs of fmap1 and fmap2 positions over sqrt(C), one matmul, then 2x2
    average pools."""
    B, C, h, w = fmap1.shape
    min_dim = 2 ** (num_levels - 1)
    assert h >= min_dim and w >= min_dim, (
        f"feature map {h}x{w} too small for {num_levels} corr levels "
        f"(needs >= {min_dim}; input must be >= {8 * min_dim} pixels)")
    f1 = fmap1.float().reshape(B, C, h * w).transpose(1, 2)
    f2 = fmap2.float().reshape(B, C, h * w)
    corr = torch.matmul(f1, f2).div_(math.sqrt(C))  # in place: the volume is the peak
    corr = corr.reshape(B * h * w, 1, h, w)
    pyramid = [corr[:, 0]]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr[:, 0])
    return pyramid


def _lookup_level(corr: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, r: int) -> torch.Tensor:
    """Bilinear window lookup on one level, zeros outside: corr [N, H, W],
    cx / cy [N] centroids -> [N, (2r+1)^2] taps at (cx + i - r, cy + j - r),
    plane k = i*(2r+1) + j (X slowest, the reference's order, which the
    update block's weights expect).

    The taps are integer-spaced around one centroid, so they share one
    fractional offset and their corners form a (2r+2)^2 patch: one gather
    of the patch, then the bilinear blend of its shifted views."""
    N, H, W = corr.shape
    P, K = 2 * r + 2, 2 * r + 1
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx, fy = (cx - x0)[:, None, None], (cy - y0)[:, None, None]
    steps = torch.arange(P, device=corr.device, dtype=cx.dtype)
    gx = (x0 - r)[:, None] + steps  # [N, P] patch columns
    gy = (y0 - r)[:, None] + steps  # [N, P] patch rows
    inb = (((gy >= 0) & (gy <= H - 1))[:, :, None]
           & ((gx >= 0) & (gx <= W - 1))[:, None, :])
    idx = gy.clamp(0, H - 1).long()[:, :, None] * W + gx.clamp(0, W - 1).long()[:, None, :]
    patch = torch.gather(corr.reshape(N, H * W), 1, idx.reshape(N, P * P)).reshape(N, P, P)
    patch = patch * inb.to(patch.dtype)  # [N, y, x]
    top = (1 - fx) * patch[:, :K, :K] + fx * patch[:, :K, 1:]
    bottom = (1 - fx) * patch[:, 1:, :K] + fx * patch[:, 1:, 1:]
    out = (1 - fy) * top + fy * bottom  # [N, j (y), i (x)]
    return out.transpose(1, 2).reshape(N, K * K)


def lookup_corr(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """coords [B, 2, h, w] (x, y) -> [B, levels*(2r+1)^2, h, w]."""
    B, _, h, w = coords.shape
    flat = coords.permute(0, 2, 3, 1).reshape(B * h * w, 2).float()
    outs = []
    for i, corr in enumerate(pyramid):
        sampled = _lookup_level(corr, flat[:, 0] / (2 ** i), flat[:, 1] / (2 ** i), radius)
        outs.append(sampled.reshape(B, h, w, -1))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2)


# ---- update block ----

class _SepConvGRU(nn.Module):
    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden + input_dim
        for suffix, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{suffix}", nn.Conv2d(cin, hidden, ks, padding=pad))

    def _pass(self, h, x, suffix):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
        q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._pass(self._pass(h, x, "1"), x, "2")


class _BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class _BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int = 128, context: int = 128):
        super().__init__()
        self.encoder = _BasicMotionEncoder(corr_planes)
        self.gru = _SepConvGRU(hidden, context + 128)
        self.flow1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.flow2 = nn.Conv2d(256, 2, 3, padding=1)
        self.mask1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.mask2 = nn.Conv2d(256, 64 * 9, 1)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow2(F.relu(self.flow1(net)))
        mask = 0.25 * self.mask2(F.relu(self.mask1(net)))
        return net, mask, delta_flow


class _RAFTStep(nn.Module):
    """Holds the update block under the flax scan's name (``step``)."""

    def __init__(self, corr_planes: int, hidden: int, context: int):
        super().__init__()
        self.update = _BasicUpdateBlock(corr_planes, hidden, context)


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsample (raft.py:73-84): flow [B, 2, H, W],
    mask [B, 576, H, W] laid out (k=9, r=8, c=8) -> [B, 2, 8H, 8W]."""
    B, _, H, W = flow.shape
    m = torch.softmax(mask.reshape(B, 9, 8, 8, H, W), dim=1)
    patches = F.unfold(8.0 * flow, 3, padding=1).reshape(B, 2, 9, 1, 1, H, W)
    up = (m[:, None] * patches).sum(dim=2)  # [B, 2, 8 (r), 8 (c), H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """forward(image1, image2) -> flow [B, 2, H, W] from image1 to image2."""

    def __init__(self, iters: int = 20, corr_levels: int = 4, corr_radius: int = 4,
                 hidden: int = 128, context: int = 128):
        super().__init__()
        self.iters, self.corr_levels, self.corr_radius = iters, corr_levels, corr_radius
        self.hidden = hidden
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden + context, "batch")
        self.step = _RAFTStep(corr_levels * (2 * corr_radius + 1) ** 2, hidden, context)

    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-frame encodings, pair-independent: images [B, 3, H, W] ->
        (fmap fp32 [B, 256, H/8, W/8], net, inp [B, hidden|context, H/8, W/8]).
        A clip encodes each frame once; the reference re-encodes both
        images of every pair in both directions."""
        fmap = self.fnet(images).float()
        ctx = self.cnet(images)
        return fmap, torch.tanh(ctx[:, :self.hidden]), F.relu(ctx[:, self.hidden:])

    def forward_encoded(self, fmap1, fmap2, net, inp) -> torch.Tensor:
        """Iterative flow from encode()'s outputs; (net, inp) are image1's."""
        B, _, h, w = fmap1.shape
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels)
        ys, xs = torch.meshgrid(torch.arange(h, device=fmap1.device),
                                torch.arange(w, device=fmap1.device), indexing="ij")
        coords0 = torch.stack([xs, ys]).float()[None].expand(B, -1, -1, -1)
        coords1 = coords0
        dtype = net.dtype
        mask = None
        for _ in range(self.iters):
            corr = lookup_corr(pyramid, coords1, self.corr_radius)
            net, mask, delta = self.step.update(net, inp, corr.to(dtype),
                                                (coords1 - coords0).to(dtype))
            coords1 = coords1 + delta.float()
        return convex_upsample_flow(coords1 - coords0, mask.float())

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        fmap1, net, inp = self.encode(image1)
        return self.forward_encoded(fmap1, self.fnet(image2).float(), net, inp)


def raft_bi_flows(raft: RAFT, frames: torch.Tensor,
                  pair_chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional flows for consecutive pairs (flow_comp_raft.py:40-55).

    frames: [B, T, 3, H, W] in [-1, 1] -> (flows_f, flows_b), each
    [B, T-1, 2, H, W]: flow t is frame t -> t+1, and t+1 -> t. The JAX
    package's ``raft_bi_flows(raft, params, frames)`` takes the flax params;
    the port's module owns its weights, so there is no ``params``.

    Every frame is encoded once, ENCODE_CHUNK frames a call. Pairs are formed
    within each clip, never across clips; both directions of ``pair_chunk``
    pairs (all pairs when None) go through one ``forward_encoded`` call.
    """
    B, T = frames.shape[:2]
    flat = frames.reshape(B * T, *frames.shape[2:])
    enc = [raft.encode(flat[s:s + ENCODE_CHUNK]) for s in range(0, B * T, ENCODE_CHUNK)]
    fmap, net, inp = (torch.cat(parts) for parts in zip(*enc))
    del enc
    # the flat index of each pair's first frame, clip by clip
    first = torch.arange(B * T, device=fmap.device).reshape(B, T)[:, :-1].reshape(-1)
    chunk = pair_chunk or len(first)
    flows_f, flows_b = [], []
    for s in range(0, len(first), chunk):
        a = first[s:s + chunk]
        b = a + 1
        flows = raft.forward_encoded(
            torch.cat([fmap[a], fmap[b]]), torch.cat([fmap[b], fmap[a]]),
            torch.cat([net[a], net[b]]), torch.cat([inp[a], inp[b]]))
        flows_f.append(flows[:len(a)])
        flows_b.append(flows[len(a):])
    shape = (B, T - 1, 2, *frames.shape[-2:])
    return torch.cat(flows_f).reshape(shape), torch.cat(flows_b).reshape(shape)
