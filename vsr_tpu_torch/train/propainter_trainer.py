"""ProPainter training on one device: counterpart of
``vsr_tpu/train/propainter_trainer.py``.

* Flow completion (the reference's video/core/trainer_flow_w_edge.py):
  masked L1 on the completed flow (hole and valid) plus a binary cross
  entropy of the edge head against Canny edges of the ground-truth flow,
  computed on the host (train/canny.py, the reference's get_edges exactly).
* Generator (video/core/trainer.py): hinge GAN against the temporal patch
  discriminator (nf 32, propainter.py:384) plus hole / valid L1 and, when
  ``perceptual_weight > 0`` and an LPIPS module is given, the LPIPS term;
  RAFT and flow completion are frozen upstream stages, so the step takes
  completed flows. Image propagation of the local frames runs without
  gradients, as the JAX step has none through it.

Layouts are the port's ProPainter ones: videos [B, T, C, H, W], flows
[B, T-1, 2, H, W]. Checkpoints are one ``ckpt_<step>.pt`` file. Data
parallelism is not ported yet (ROADMAP item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from vsr_tpu_torch.inpaint.weights import init_random_
from vsr_tpu_torch.models.discriminator import VideoDiscriminator
from vsr_tpu_torch.models.lpips import LPIPS
from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet
from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator, image_propagation
from vsr_tpu_torch.train.canny import flow_edges_host
from vsr_tpu_torch.train.losses import masked_l1
from vsr_tpu_torch.train.perceptual import lpips_loss
from vsr_tpu_torch.train.sttn_trainer import (
    Checkpointed,
    gan_update,
    make_optimizer,
    refuse_mesh,
)
from vsr_tpu_torch.utils.device import resolve_device


# --------------------------------------------------------- flow completion

@dataclass
class FlowTrainConfig:
    lr: float = 5e-5
    beta1: float = 0.0
    beta2: float = 0.99
    flow_weight: float = 0.25
    edge_weight: float = 1.0
    save_dir: str = "flow_ckpt"


class FlowCompletionTrainer(Checkpointed):
    """Adam at a constant rate on RecurrentFlowCompleteNet with its edge
    head (built and seeded here unless ``net`` is given)."""

    def __init__(self, cfg: Optional[FlowTrainConfig] = None,
                 net: Optional[RecurrentFlowCompleteNet] = None,
                 device="cuda", seed: int = 0, mesh=None):
        refuse_mesh(mesh)
        self.cfg = cfg or FlowTrainConfig()
        self.device = resolve_device(device)
        if net is None:
            net = RecurrentFlowCompleteNet(edge_head=True)
            init_random_(net, seed)
        if net.edge is None:
            raise ValueError("the flow-completion trainer needs the edge head: "
                             "RecurrentFlowCompleteNet(edge_head=True)")
        self.net = net.to(self.device).train()
        self.opt, self.sched = make_optimizer(self.net, self.cfg)
        self.step_count = 0

    def _modules(self):
        return {"net": self.net, "opt": self.opt, "sched": self.sched}

    def train_step(self, gt_flows, masks) -> Dict[str, torch.Tensor]:
        """gt_flows [B, T, 2, H, W], masks [B, T, 1, H, W] (numpy or
        tensors) -> loss, hole_l1, valid_l1, edge_bce (detached 0-d
        tensors), having stepped the net (propainter_trainer.py:62-98)."""
        gt = torch.as_tensor(gt_flows, dtype=torch.float32)
        # edge targets on the host, in the channels-last layout of canny.py
        edges_np = flow_edges_host(np.moveaxis(gt.numpy(), 2, -1))
        targets = torch.from_numpy(np.ascontiguousarray(np.moveaxis(edges_np, -1, 2)))
        gt, targets = gt.to(self.device), targets.to(self.device)
        masks = torch.as_tensor(masks, dtype=torch.float32).to(self.device)
        pred, edges = self.net(gt * (1 - masks), masks, train=True)
        hole = masked_l1(pred, gt, masks)
        valid = masked_l1(pred, gt, 1 - masks)
        edges = edges.reshape(targets.shape)
        bce = -(targets * torch.log(edges + 1e-8) + (1 - targets) * torch.log(1 - edges + 1e-8))
        edge = bce.mean()
        loss = self.cfg.flow_weight * (hole + valid) + self.cfg.edge_weight * edge
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.sched.step()
        self.step_count += 1
        return {"loss": loss.detach(), "hole_l1": hole.detach(), "valid_l1": valid.detach(),
                "edge_bce": edge.detach()}


# ------------------------------------------------------------- generator

@dataclass
class PropainterTrainConfig:
    lr: float = 1e-4
    beta1: float = 0.0
    beta2: float = 0.99
    hole_weight: float = 1.0
    valid_weight: float = 1.0
    adversarial_weight: float = 0.01
    # LPIPS perceptual term (ref trainer.py:67-68,413-417; weight 0 in the
    # published configs' default — enabled when an LPIPS module is given)
    perceptual_weight: float = 0.0
    gan_loss: str = "hinge"
    save_dir: str = "propainter_ckpt"


class PropainterTrainer(Checkpointed):
    """The generator's GAN step (propainter_trainer.py:150-300) with its
    state: the generator (default full width: channel 128, hidden 512, 8
    blocks), the discriminator (nf 32), an Adam each at a constant rate.
    ``lpips``: a frozen LPIPS module for the perceptual term."""

    def __init__(self, cfg: Optional[PropainterTrainConfig] = None,
                 num_local_frames: int = 10,
                 generator: Optional[ProPainterGenerator] = None,
                 discriminator: Optional[VideoDiscriminator] = None,
                 lpips: Optional[LPIPS] = None, device="cuda", seed: int = 0, mesh=None):
        refuse_mesh(mesh)
        self.cfg = cfg or PropainterTrainConfig()
        self.num_local_frames = num_local_frames
        self.device = resolve_device(device)
        if generator is None:
            generator = ProPainterGenerator()
            init_random_(generator, seed)
        if discriminator is None:
            discriminator = VideoDiscriminator(nf=32, use_sigmoid=self.cfg.gan_loss != "hinge",
                                               seed=seed + 1)
            init_random_(discriminator, seed + 1)
        self.generator = generator.to(self.device).train()
        self.discriminator = discriminator.to(self.device).train()
        self.lpips = None
        if lpips is not None:
            self.lpips = lpips.to(self.device).eval().requires_grad_(False)
        self.gen_opt, self.gen_sched = make_optimizer(self.generator, self.cfg)
        self.dis_opt, self.dis_sched = make_optimizer(self.discriminator, self.cfg)
        self.step_count = 0

    def _modules(self):
        return {"generator": self.generator, "discriminator": self.discriminator,
                "gen_opt": self.gen_opt, "dis_opt": self.dis_opt,
                "gen_sched": self.gen_sched, "dis_sched": self.dis_sched}

    def step(self, frames, flows_f, flows_b, masks) -> Dict[str, torch.Tensor]:
        """frames [B, T, 3, H, W] in [-1, 1] (the first num_local_frames
        local, the rest reference frames), completed flows [B, lt-1, 2, H,
        W] each way, masks [B, T, 1, H, W] -> dis_loss, gen_loss, gan_loss,
        hole_loss, valid_loss, perc_loss (detached 0-d tensors)."""
        cfg, l_t = self.cfg, self.num_local_frames

        def tensor(x):
            return torch.as_tensor(x, dtype=torch.float32).to(self.device)

        frames, flows_f, flows_b, masks = map(tensor, (frames, flows_f, flows_b, masks))
        masked = frames * (1 - masks)
        local_masks, local_frames = masks[:, :l_t], frames[:, :l_t]
        with torch.no_grad():
            prop_frames, updated_masks = image_propagation(
                masked[:, :l_t], local_masks, flows_f, flows_b)
            updated = masked[:, :l_t] * (1 - local_masks) + prop_frames * local_masks
            updated_all = torch.cat([updated, masked[:, l_t:]], dim=1)
            updated_masks_all = torch.cat([updated_masks, masks[:, l_t:]], dim=1)

        pred = self.generator(updated_all, (flows_f, flows_b), masks, updated_masks_all, l_t)
        comp = local_frames * (1 - local_masks) + pred * local_masks
        d_loss, _, _, gan = gan_update(self.discriminator, self.dis_opt, local_frames, comp,
                                       cfg.gan_loss)
        gan = gan * cfg.adversarial_weight
        hole = masked_l1(pred, local_frames, local_masks) * cfg.hole_weight
        valid = masked_l1(pred, local_frames, 1 - local_masks) * cfg.valid_weight
        perc = torch.zeros((), device=self.device)
        if cfg.perceptual_weight > 0 and self.lpips is not None:
            H, W = pred.shape[-2:]
            perc = lpips_loss(self.lpips, pred.reshape(-1, 3, H, W),
                              local_frames.reshape(-1, 3, H, W),
                              use_input_norm=True, range_norm=True) * cfg.perceptual_weight
        g_loss = gan + hole + valid + perc
        self.gen_opt.zero_grad(set_to_none=True)
        g_loss.backward()
        self.gen_opt.step()
        self.gen_sched.step()
        self.dis_sched.step()
        self.step_count += 1
        values = (d_loss, g_loss, gan, hole, valid, perc)
        keys = ("dis_loss", "gen_loss", "gan_loss", "hole_loss", "valid_loss", "perc_loss")
        return {k: v.detach() for k, v in zip(keys, values)}
