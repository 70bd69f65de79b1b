"""PFHeadLocal, the PP-OCRv5 detection head (PyTorch), inference half.

Counterpart of ``vsr_tpu/detect/heads.py`` (PaddleOCR det_db_head.py): the
binarize branch (conv3x3 + BN/ReLU -> 2x deconv + BN/ReLU -> 2x deconv ->
sigmoid) and the LocalModule calibration over [shrink map, upsampled
pre-logit feature]; the output is 0.5 * (base + cbn). NCHW, flax module
names. The ``thresh`` branch serves only DB training (the JAX package calls
it with ``train=True``); the port has no training slice yet, so it has no
such branch and ``dbnet_state_dict_from_flax`` drops its params by name.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vsr_tpu_torch.detect.necks import upsample_nearest


class DBBranchHead(nn.Module):
    """Three stages from stride-4 features to a full-resolution map."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels // 4
        self.conv1 = nn.Conv2d(in_channels, c, 3, padding=1, bias=False)
        self.conv_bn1 = nn.BatchNorm2d(c, eps=1e-5)
        # k2 s2: every output pixel has exactly one tap (flax SAME == paddle p0)
        self.conv2 = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.conv_bn2 = nn.BatchNorm2d(c, eps=1e-5)
        self.conv3 = nn.ConvTranspose2d(c, 1, 2, stride=2)

    def forward(self, x: torch.Tensor, return_f: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        x = F.relu(self.conv_bn1(self.conv1(x)))
        f = F.relu(self.conv_bn2(self.conv2(x)))
        x = torch.sigmoid(self.conv3(f))
        return (x, f) if return_f else x


class LocalModule(nn.Module):
    """conv3x3-BN-ReLU over [shrink map, feature], then a 1x1 conv."""

    def __init__(self, in_channels: int, mid_channels: int):
        super().__init__()
        self.last_3_conv = nn.Conv2d(in_channels, mid_channels, 3, padding=1, bias=False)
        self.last_3_bn = nn.BatchNorm2d(mid_channels, eps=1e-5)
        self.last_1 = nn.Conv2d(mid_channels, 1, 1)

    def forward(self, x: torch.Tensor, init_map: torch.Tensor) -> torch.Tensor:
        out = torch.cat([init_map, x], dim=1)
        return self.last_1(F.relu(self.last_3_bn(self.last_3_conv(out))))


class PFHeadLocal(nn.Module):
    """[B, C, H/4, W/4] fused features -> [B, 1, H, W] probability map.

    Mode "large" (the server preset): LocalModule C/4 + 1 -> C/4. The
    mobile preset's "small" (-> C/8) comes with that preset."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.binarize = DBBranchHead(in_channels)
        self.cbn_layer = LocalModule(in_channels // 4 + 1, in_channels // 4)

    def forward(self, fuse: torch.Tensor) -> torch.Tensor:
        base, f = self.binarize(fuse, return_f=True)
        cbn = torch.sigmoid(self.cbn_layer(upsample_nearest(f, 2), base))
        return 0.5 * (base + cbn)
