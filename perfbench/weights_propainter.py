"""Seeded ProPainter weights in the published checkpoint layouts, made on
the device from a ``torch.Generator`` seeded with the run's seed, and the
checkpoint files the tool loads.

The state dict is the plain reference's (``reference/propainter.py``):
``raft.`` is raft-things.pth without DataParallel's ``module.``,
``flow_net.`` recurrent_flow_completion.pth (its training-only edge head
included), ``generator.`` ProPainter.pth. Convolution and linear weights
are LeCun-normal (N(0, 1 / fan_in)), biases N(0, 0.02); batch norms get
scale 1 + N(0, 0.02), running means N(0, 0.1) and running variances
U(0.5, 1.5); layer norms scale 1 + N(0, 0.02); the token pools the average
(upstream's start) plus N(0, 0.02).

Drawn so alone, the three networks' outputs sit where no change of
precision shows: RAFT's flows run to hundreds of pixels or stay at
nothing, the completed flows likewise, and the generator's frames
saturate at 0 or 255. So three last layers are calibrated in float32 with
TF32 off, on seeded noise frames at ``calibration_hw`` (at least 8 x 2 **
levels rows and columns: RAFT's sampler divides by a level's side less
one, so a level one row high is not defined): RAFT's flow head
(``raft.update_block.flow_head.conv2``) is scaled until the flows' RMS is
``FLOW_RMS`` pixels (the iterations feed the flow back, so a few rounds);
the flow-completion head (``flow_net.upsample.2.conv``) and the
generator's last convolution (``generator.decoder.6``) are shifted and
scaled per output channel, to flows of RMS ``FLOW_RMS`` and to logits of
mean 0 and standard deviation ``LOGIT_STD`` before the tanh, as
``weights.py`` does for STTN."""

from __future__ import annotations

import math
import os
from typing import Dict

import torch
from torch import nn

from perfbench.reference.propainter import ProPainter

BIAS_STD = 0.02
LOGIT_STD = 0.7
FLOW_RMS = 8.0  # pixels
RAFT_ROUNDS = 4

# the published files, by the reference's prefix
CHECKPOINTS = {"raft.": "raft-things.pth", "flow_net.": "recurrent_flow_completion.pth",
               "generator.": "ProPainter.pth"}


def reference_model(cfg: dict, quant: str = "float32") -> ProPainter:
    return ProPainter(cfg, quant)


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict, on ``device``, named as the reference's."""
    device = torch.device(device)
    with torch.device(device):
        model = reference_model(cfg)
    model = model.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    norms = {id(p) for m in model.modules()
             if isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)) for p in m.parameters()}
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.copy_(randn(p.shape) * BIAS_STD)
        elif id(p) in norms:
            p.copy_(1 + randn(p.shape) * BIAS_STD)
        elif name.endswith("pool_layer.weight"):
            p.copy_(1.0 / math.prod(p.shape[2:]) + randn(p.shape) * BIAS_STD)
        else:
            p.copy_(randn(p.shape) / math.sqrt(math.prod(p.shape[1:])))
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(randn(b.shape) * 0.1)
        elif name.endswith("running_var"):
            b.copy_(0.5 + torch.rand(b.shape, generator=gen, device=device))
    _calibrate(model, cfg, gen, device)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bad = [k for k, v in state.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad:
        raise ValueError(f"calibration left non-finite weights: {bad[:4]}")
    return state


def _calibrate(model: ProPainter, cfg: dict, gen: torch.Generator, device) -> None:
    h, w = cfg["calibration_hw"]
    T = cfg["neighbor_length"] + 1
    frames = torch.rand((T, 3, h, w), generator=gen, device=device) * 2 - 1
    masks = torch.zeros((1, T, 1, h, w), device=device)
    masks[..., h // 4: 3 * h // 4, w // 8: 7 * w // 8] = 1
    q, r = model.q, cfg["raft"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            head = model.raft.update_block.flow_head.conv2
            for _ in range(RAFT_ROUNDS):
                flows = model.raft.bi_flows(frames[:2], r["iters"], 1, q)
                rms = float(torch.cat(flows).pow(2).mean().sqrt())
                gain = FLOW_RMS / max(rms, 1e-6)
                head.weight.mul_(gain)
                head.bias.mul_(gain)
            flows = tuple(f[None] for f in model.raft.bi_flows(frames, r["iters"], T, q))
            net = model.flow_net
            pred = torch.cat(net.forward_bidirect_flow(flows, masks, q), dim=1)
            _standardise(net.upsample[2].conv, pred, FLOW_RMS, center=False)
            completed = net.combine_flow(flows, net.forward_bidirect_flow(flows, masks, q),
                                         masks)
            gen = model.generator
            logits = gen.forward_encoded(gen.encode(frames[None], masks, masks, q), completed,
                                         masks, masks, T, q, logits=True)
            _standardise(model.generator.decoder[6], logits, LOGIT_STD, center=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _standardise(layer: nn.Conv2d, out: torch.Tensor, std: float, center: bool) -> None:
    """Scales (and with ``center`` shifts) ``layer``'s output channels, whose
    outputs were ``out`` [..., C, H, W], to a standard deviation ``std``
    (mean 0), or to an RMS ``std`` without ``center``."""
    dims = [d for d in range(out.dim()) if d != out.dim() - 3]
    mean = out.mean(dim=dims) if center else torch.zeros(out.shape[-3], device=out.device)
    spread = (out - mean.view(-1, 1, 1)).pow(2).mean(dim=dims).sqrt()
    gain = std / spread.clamp_min(1e-6)
    layer.weight.mul_(gain.view(-1, *[1] * (layer.weight.dim() - 1)))
    layer.bias.copy_((layer.bias - mean) * gain)


def write_checkpoints(state: Dict[str, torch.Tensor], directory: str) -> None:
    """The three published checkpoint files in ``directory``; RAFT's keys
    carry DataParallel's ``module.``, as raft-things.pth's do."""
    for prefix, filename in CHECKPOINTS.items():
        keep = {k[len(prefix):]: v.cpu() for k, v in state.items() if k.startswith(prefix)}
        if prefix == "raft.":
            keep = {f"module.{k}": v for k, v in keep.items()}
        torch.save(keep, os.path.join(directory, filename))
