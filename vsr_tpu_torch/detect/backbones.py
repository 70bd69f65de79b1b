"""The PP-OCRv5 detectors' backbones (PyTorch): PP-LCNetV3 (mobile preset)
and PP-HGNetV2-B4 (server preset).

Counterpart of ``vsr_tpu/detect/backbones.py`` (weight-level
reconstructions of PaddleOCR's rec_lcnetv3.py and rec_pphgnetv2.py,
det=True). Modules compute in NCHW and carry the flax module names
(``stem.stem1.conv``, ``stages_1.blocks_0.layers_0``, ``blocks5_1.dw_conv``,
...), so the JAX package's params load through
``convert.from_flax.dbnet_state_dict_from_flax`` by name. Both return four
feature maps at strides 4/8/16/32.

Every BatchNorm runs in inference mode on its running statistics. LCNetV3's
LearnableRepLayer keeps its multi-branch form, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# in_c, mid_c, out_c, num_blocks, downsample, light_block, kernel, layer_num
# (vsr_tpu/detect/backbones.py:305-310)
HGNETV2_B4_STAGES: Tuple[Tuple, ...] = (
    (48, 48, 128, 1, False, False, 3, 6),
    (128, 96, 512, 1, True, False, 3, 6),
    (512, 192, 1024, 3, True, True, 5, 6),
    (1024, 384, 2048, 1, True, True, 5, 6),
)


class ConvBN(nn.Module):
    """Paddle ConvBNLayer: conv (no bias, symmetric pad (k-1)//2) + BN,
    optional ReLU. A grouped conv's weight is (cout, cin / groups, k, k):
    the flax depthwise kernel (k, k, 1, C) becomes (C, 1, k, k)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: Optional[str] = None):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError(f"unsupported activation: {act}")
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act == "relu" else x


# ---------------- PP-LCNetV3 (mobile preset) ----------------


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor, slope: float) -> torch.Tensor:
    """clip(slope * x + 0.5, 0, 1): slope 1/6 is paddle's nn.Hardsigmoid
    (LCNetV3's SELayer), 0.2 det_mobilenet_v3's (the neck's SEModule)."""
    return (x * slope + 0.5).clamp(0.0, 1.0)


class LearnableAffineBlock(nn.Module):
    """Scalar ``weight * x + bias`` (rec_lcnetv3.py LearnableAffineBlock).

    The flax module names its two (1,) params ``scale`` and ``bias``; here
    they are ``weight`` and ``bias``, the names dbnet_state_dict_from_flax
    gives them by its rule for affine parameters (the one BatchNorm uses)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def reset_parameters(self) -> None:
        """flax's start values: scale 1, bias 0."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight * x + self.bias


class SELayer(nn.Module):
    """LCNet squeeze-excite: pool -> 1x1 ReLU -> 1x1 hard sigmoid (slope
    1/6) -> scale."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels // reduction, 1)
        self.conv2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = F.relu(self.conv1(x.mean(dim=(2, 3), keepdim=True)))
        return x * hard_sigmoid(self.conv2(att), 1.0 / 6.0)


class LearnableRepLayer(nn.Module):
    """Multi-branch re-parameterizable conv (rec_lcnetv3.py):
    ``act_lab(hswish(lab(identity_bn(x) + conv_1x1(x) + sum conv_kxk_i(x))))``.
    The identity BN exists only when cin == cout and stride == 1; at
    stride 2 the hswish and ``act_lab`` are skipped."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, num_branches: int = 4):
        super().__init__()
        self.stride, self.num_branches = stride, num_branches
        self.identity = (nn.BatchNorm2d(cin, eps=1e-5)
                         if cin == cout and stride == 1 else None)
        self.conv_1x1 = ConvBN(cin, cout, 1, stride, groups) if kernel > 1 else None
        for i in range(num_branches):
            self.add_module(f"conv_kxk_{i}", ConvBN(cin, cout, kernel, stride, groups))
        self.lab = LearnableAffineBlock()
        self.act_lab = LearnableAffineBlock() if stride != 2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.identity(x) if self.identity is not None else 0.0
        if self.conv_1x1 is not None:
            out = out + self.conv_1x1(x)
        for i in range(self.num_branches):
            out = out + getattr(self, f"conv_kxk_{i}")(x)
        out = self.lab(out)
        if self.act_lab is not None:
            out = self.act_lab(F.hardswish(out))
        return out


class LCNetV3Block(nn.Module):
    """Depthwise-separable block: rep depthwise conv (+SE) + rep 1x1 conv."""

    def __init__(self, cin: int, cout: int, stride: int, dw_size: int, use_se: bool):
        super().__init__()
        self.dw_conv = LearnableRepLayer(cin, cin, dw_size, stride, groups=cin)
        self.se = SELayer(cin) if use_se else None
        self.pw_conv = LearnableRepLayer(cin, cout, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw_conv(x)
        if self.se is not None:
            x = self.se(x)
        return self.pw_conv(x)


# k, in_c, out_c, stride, use_se (rec_lcnetv3.py NET_CONFIG_det,
# vsr_tpu/detect/backbones.py:173-182)
_LCNET_DET_CONFIG = {
    "blocks2": [(3, 16, 32, 1, False)],
    "blocks3": [(3, 32, 64, 2, False), (3, 64, 64, 1, False)],
    "blocks4": [(3, 64, 128, 2, False), (3, 128, 128, 1, False)],
    "blocks5": [(3, 128, 256, 2, False), (5, 256, 256, 1, False),
                (5, 256, 256, 1, False), (5, 256, 256, 1, False),
                (5, 256, 256, 1, False)],
    "blocks6": [(5, 256, 512, 2, True), (5, 512, 512, 1, True),
                (5, 512, 512, 1, False), (5, 512, 512, 1, False)],
}
_LCNET_DET_MV_C = (16, 24, 56, 480)


class PPLCNetV3(nn.Module):
    """PP-LCNetV3 det backbone (PP-OCRv5_mobile_det, scale 0.75):
    [B, 3, H, W] -> 4 maps at strides 4..32, projected by 1x1 convs
    (``layer_list_{i}``) to int(mv * scale) channels."""

    def __init__(self, scale: float = 0.75):
        super().__init__()
        c = make_divisible(16 * scale)
        self.conv1 = ConvBN(3, c, 3, 2)  # no activation (paddle's ConvBNLayer)
        taps = []
        for group, blocks in _LCNET_DET_CONFIG.items():
            for bi, (k, _, out_c, stride, se) in enumerate(blocks):
                out = make_divisible(out_c * scale)
                self.add_module(f"{group}_{bi}", LCNetV3Block(c, out, stride, k, se))
                c = out
            taps.append(c)
        self._blocks = [f"{g}_{i}" for g, b in _LCNET_DET_CONFIG.items() for i in range(len(b))]
        # taps after blocks3..6: strides 4/8/16/32
        self._taps = {f"{g}_{len(b) - 1}" for g, b in list(_LCNET_DET_CONFIG.items())[1:]}
        self.out_channels = [int(mv * scale) for mv in _LCNET_DET_MV_C]
        for i, (cin, cout) in enumerate(zip(taps[1:], self.out_channels)):
            self.add_module(f"layer_list_{i}", nn.Conv2d(cin, cout, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.conv1(x)
        outs = []
        for name in self._blocks:
            x = getattr(self, name)(x)
            if name in self._taps:
                outs.append(x)
        return [getattr(self, f"layer_list_{i}")(o) for i, o in enumerate(outs)]


# ---------------- PP-HGNetV2-B4 (server preset) ----------------


class LightConvBNAct(nn.Module):
    """1x1 conv (no act) + depthwise kxk conv (ReLU)."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 1)
        self.conv2 = ConvBN(cout, cout, kernel, groups=cout, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class HGV2Stem(nn.Module):
    """Stride-4 stem 3 -> 32 -> 48 with a pooled/conv two-path merge. The
    two k2 s1 convs and the k2 s1 max-pool read the input padded by one zero
    row and column at the bottom and right (paddle F.pad([0, 1, 0, 1]) +
    VALID)."""

    out_channels = 48

    def __init__(self):
        super().__init__()
        mid, out = 32, self.out_channels
        self.stem1 = ConvBN(3, mid, 3, 2, act="relu")
        self.stem2a = ConvBN(mid, mid // 2, 2, 1, act="relu")
        self.stem2b = ConvBN(mid // 2, mid, 2, 1, act="relu")
        self.stem3 = ConvBN(2 * mid, mid, 3, 2, act="relu")
        self.stem4 = ConvBN(mid, out, 1, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem1(x)
        xp = F.pad(x, (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(xp), (0, 1, 0, 1)))
        x1 = F.max_pool2d(xp, 2, stride=1)
        return self.stem4(self.stem3(torch.cat([x1, x2], dim=1)))


class HGV2Block(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, kernel: int,
                 layer_num: int, light: bool, identity: bool):
        super().__init__()
        self.layer_num = layer_num
        self.identity = identity
        c = cin
        for i in range(layer_num):
            layer = (LightConvBNAct(c, mid, kernel) if light
                     else ConvBN(c, mid, kernel, act="relu"))
            self.add_module(f"layers_{i}", layer)
            c = mid
        self.aggregation_squeeze_conv = ConvBN(cin + layer_num * mid, out // 2, 1, act="relu")
        self.aggregation_excite_conv = ConvBN(out // 2, out, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        h = x
        for i in range(self.layer_num):
            h = getattr(self, f"layers_{i}")(h)
            outs.append(h)
        y = self.aggregation_excite_conv(self.aggregation_squeeze_conv(torch.cat(outs, dim=1)))
        return y + x if self.identity else y


class HGV2Stage(nn.Module):
    def __init__(self, cin: int, cfg: Sequence):
        super().__init__()
        in_c, mid_c, out_c, num_blocks, downsample, light, kernel, layer_num = cfg
        self.num_blocks = num_blocks
        self.downsample = (ConvBN(cin, in_c, 3, 2, groups=in_c) if downsample else None)
        c = in_c if downsample else cin
        for b in range(num_blocks):
            self.add_module(f"blocks_{b}", HGV2Block(
                c, mid_c, out_c, kernel, layer_num, light, identity=b > 0))
            c = out_c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for b in range(self.num_blocks):
            x = getattr(self, f"blocks_{b}")(x)
        return x


class PPHGNetV2B4(nn.Module):
    """PP-HGNetV2-B4 det backbone: [B, 3, H, W] -> 4 maps at strides 4..32.

    ``stages_override`` substitutes tiny stage configs in unit tests (the
    JAX package's ``stages_override``); the default is the B4 det program.
    """

    def __init__(self, stages_override: Optional[Sequence[Sequence]] = None):
        super().__init__()
        self.stem = HGV2Stem()
        stages = tuple(stages_override or HGNETV2_B4_STAGES)
        self.num_stages = len(stages)
        c = HGV2Stem.out_channels
        for i, cfg in enumerate(stages):
            self.add_module(f"stages_{i}", HGV2Stage(c, cfg))
            c = cfg[2]  # the stage's out_c
        self.out_channels = [cfg[2] for cfg in stages]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"stages_{i}")(x)
            outs.append(x)
        return outs
