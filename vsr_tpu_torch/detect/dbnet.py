"""PP-OCRv5 DBNet text detector (PyTorch): counterpart of
``vsr_tpu/detect/dbnet.py``.

Preset "server" (PP-OCRv5_server_det, the JAX package's default detector):
PPHGNetV2-B4 (det) -> LKPAN(256, mode=large, intracl) -> PFHeadLocal(large).
Preset "mobile" (PP-LCNetV3 + RSEFPN) is not ported yet.

Contract, as in the JAX package: BGR image with ImageNet normalization at
960-long-side /32 buckets (detect/preprocess.py) in, probability map in
[0, 1] at input resolution out, both NHWC; NCHW inside.
``hg_stages``/``fpn_channels`` shrink the graph for unit tests.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vsr_tpu_torch.detect.backbones import PPHGNetV2B4
from vsr_tpu_torch.detect.heads import PFHeadLocal
from vsr_tpu_torch.detect.necks import LKPAN


class DBNet(nn.Module):
    def __init__(self, preset: str = "server", fpn_channels: Optional[int] = None,
                 hg_stages: Optional[Sequence[Sequence]] = None):
        super().__init__()
        if preset == "mobile":
            raise NotImplementedError(
                "the mobile DBNet preset (PP-LCNetV3 + RSEFPN) is not ported to "
                "vsr_tpu_torch yet (ROADMAP.md Queue 1 item 6)")
        if preset != "server":
            raise ValueError(f"unknown DBNet preset: {preset}")
        nc = fpn_channels or 256
        self.backbone = PPHGNetV2B4(stages_override=hg_stages)
        self.neck = LKPAN(self.backbone.out_channels, nc)
        self.head = PFHeadLocal(nc)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] normalized, H and W multiples of 32 ->
        probability map [B, H, W, 1]."""
        x = images.permute(0, 3, 1, 2)
        return self.head(self.neck(self.backbone(x))).permute(0, 2, 3, 1)
