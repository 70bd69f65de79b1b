"""PP-HGNetV2-B4, the PP-OCRv5 server detector's backbone (PyTorch).

Counterpart of ``ConvBN`` and the HGNetV2 half of
``vsr_tpu/detect/backbones.py`` (a weight-level reconstruction of
PaddleOCR's rec_pphgnetv2.py, det=True). Modules compute in NCHW and carry
the flax module names (``stem.stem1.conv``, ``stages_1.blocks_0.layers_0``,
...), so the JAX package's params load through
``convert.from_flax.dbnet_state_dict_from_flax`` by name. Returns four
feature maps at strides 4/8/16/32.

The mobile preset's PP-LCNetV3 is not ported yet (ROADMAP.md Queue 1 item
6). Every BatchNorm runs in inference mode on its running statistics.
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
    optional ReLU."""

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
