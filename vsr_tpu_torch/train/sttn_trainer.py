"""STTN GAN trainer on one device: counterpart of
``vsr_tpu/train/sttn_trainer.py`` (the reference trainer,
backend/tools/train/trainer_sttn.py:17-319 with
configs_sttn/youtube-vos.json): hinge adversarial loss against the
spectral-norm 3D-conv video discriminator, hole + valid L1 on the generator,
Adam(0, 0.99) at lr 1e-4 with the step decay
0.1 ** (min(step, niter_steady) // niter), ``torch.save`` checkpoints with
full resume.

The generator is built with ``use_kernel=False``: the token-attention CUDA
kernel is forward-only (ops/token_attention.py), so training takes the plain
attention route, as the JAX package trains without its Pallas kernel. One
generator forward serves both updates: the JAX step runs it twice with the
same parameters, so the results agree.

Across processes (the JAX package's ``mesh=``): a
``parallel.distributed.TrainingMesh`` of ``data x model`` process groups, one
process per device. Every rank starts from rank 0's weights (broadcast),
takes its slice of the same global batch, normalises the masked L1 terms by
the global batch's mask density and averages gradients and metrics over the
data group before each optimizer step: the step equals the one-process step
on the global batch, as GSPMD's does. With a model group the generator's
convolutions are split over it by output channel
(``parallel.mesh.shard_params``). Rank 0 alone writes checkpoints and
scalars; every rank restores.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from vsr_tpu_torch.inpaint.weights import init_random_
from vsr_tpu_torch.models.discriminator import VideoDiscriminator
from vsr_tpu_torch.models.sttn import STTNGenerator
from vsr_tpu_torch.parallel.distributed import TrainingMesh
from vsr_tpu_torch.parallel.mesh import (
    load_optimizer_state_dict,
    optimizer_state_dict,
    shard_params,
)
from vsr_tpu_torch.train.losses import adversarial_loss, masked_l1
from vsr_tpu_torch.train.lr_schedulers import Schedule, sttn_step_decay
from vsr_tpu_torch.utils.device import resolve_device

METRICS = ("dis_loss", "dis_real", "dis_fake", "gen_loss", "gan_loss", "hole_loss", "valid_loss")


@dataclass
class TrainConfig:
    # losses (ref configs_sttn/youtube-vos.json)
    hole_weight: float = 1.0
    valid_weight: float = 1.0
    adversarial_weight: float = 0.01
    gan_loss: str = "hinge"
    # optimizer
    lr: float = 1e-4
    beta1: float = 0.0
    beta2: float = 0.99
    # schedule
    iterations: int = 500_000
    niter: int = 150_000
    niter_steady: int = 300_000
    # data
    batch_size: int = 8
    sample_length: int = 5
    frame_w: int = 640
    frame_h: int = 120
    # checkpoints
    save_dir: str = "release_model"
    save_freq: int = 10_000
    log_freq: int = 100
    # scalar summaries (ref trainer_sttn.py:96-128 tensorboardX writers);
    # None disables. JSONL always; tensorboard(X) when importable.
    summary_dir: Optional[str] = None


def lr_schedule(cfg: TrainConfig) -> Schedule:
    return sttn_step_decay(cfg.lr, cfg.niter, cfg.niter_steady)


def make_optimizer(module: nn.Module, cfg, schedule: Optional[Schedule] = None
                   ) -> Tuple[torch.optim.Adam, LambdaLR]:
    """Adam(beta1, beta2) at the schedule's rate: the optimizer's base rate
    is 1.0, so LambdaLR sets the rate to the schedule's value itself. A
    config without a schedule (``schedule=None``) trains at ``cfg.lr``."""
    opt = torch.optim.Adam(module.parameters(), lr=1.0, betas=(cfg.beta1, cfg.beta2))
    return opt, LambdaLR(opt, schedule or (lambda step: cfg.lr))


def check_mesh(mesh) -> Optional[TrainingMesh]:
    """A trainer's ``mesh``: None (one process) or a TrainingMesh. An
    inference mesh (a list of devices) raises: training needs the process
    groups."""
    if mesh is not None and not isinstance(mesh, TrainingMesh):
        raise TypeError(f"a trainer's mesh is a parallel.distributed.TrainingMesh (process "
                        f"groups, one process per device), not {type(mesh).__name__}")
    return mesh


@contextlib.contextmanager
def frozen(module: nn.Module):
    """No parameter gradients for ``module`` inside (inputs still get theirs)."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def gan_update(discriminator: nn.Module, dis_opt: torch.optim.Optimizer,
               real: torch.Tensor, fake: torch.Tensor, gan_type: str,
               mesh: Optional[TrainingMesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One discriminator update and the generator's adversarial term, in
    the JAX steps' order (sttn_trainer.py:127-148): the real pass stores the
    spectral norms' power iteration, the fake pass (on ``fake`` detached)
    starts from it without storing; Adam steps the discriminator; then the
    updated discriminator scores ``fake`` with its parameters frozen, so the
    term's gradient reaches the generator only. real / fake: [B, T, 3, H, W]
    (with a mesh, this rank's slice: the discriminator's gradients are
    averaged over the data group before its step). Returns (d_loss, d_real,
    d_fake, generator's adversarial loss), this rank's."""
    d_real = adversarial_loss(discriminator(real, update_stats=True), True, True, gan_type)
    d_fake = adversarial_loss(discriminator(fake.detach()), False, True, gan_type)
    d_loss = (d_real + d_fake) / 2.0
    dis_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    if mesh is not None:
        mesh.average_gradients(discriminator)
    dis_opt.step()
    with frozen(discriminator):
        gan = adversarial_loss(discriminator(fake), True, False, gan_type)
    return d_loss, d_real, d_fake, gan


def make_train_step(generator: STTNGenerator, discriminator: VideoDiscriminator,
                    gen_opt: torch.optim.Optimizer, dis_opt: torch.optim.Optimizer,
                    cfg: TrainConfig, mesh: Optional[TrainingMesh] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """The GAN step: step(frames [B, T, H, W, 3] in [-1, 1], masks
    [B, T, H, W, 1] in {0, 1}) -> metrics (detached 0-d tensors), having
    updated both networks (vsr_tpu/train/sttn_trainer.py:105-175). With a
    mesh, frames and masks are this rank's slice of the global batch and
    the metrics are the global batch's."""

    def step(frames: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        masked = frames * (1.0 - masks)
        pred = generator(masked, masks)
        comp = masked + pred * masks
        d_loss, d_real, d_fake, gan = gan_update(
            discriminator, dis_opt, frames.permute(0, 1, 4, 2, 3),
            comp.permute(0, 1, 4, 2, 3), cfg.gan_loss, mesh)
        gan = gan * cfg.adversarial_weight
        hole = masked_l1(pred, frames, masks, mesh) * cfg.hole_weight
        valid = masked_l1(pred, frames, 1.0 - masks, mesh) * cfg.valid_weight
        g_loss = gan + hole + valid
        gen_opt.zero_grad(set_to_none=True)
        g_loss.backward()
        if mesh is not None:
            mesh.average_gradients(generator)
        gen_opt.step()
        return global_metrics(METRICS, (d_loss, d_real, d_fake, g_loss, gan, hole, valid), mesh)

    return step


def global_metrics(keys, values, mesh: Optional[TrainingMesh]) -> Dict[str, torch.Tensor]:
    """Detached metrics by name, averaged over the mesh's data group (one
    all_reduce): the global batch's values on every rank."""
    stacked = torch.stack([v.detach() for v in values])
    if mesh is not None:
        stacked = mesh.data_mean(stacked)
    return dict(zip(keys, stacked.unbind()))


def as_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Metric tensors -> floats with one device-to-host copy."""
    values = torch.stack(list(metrics.values())).tolist()
    return dict(zip(metrics, values))


def replicate_or_shard(*modules: nn.Module, mesh: Optional[TrainingMesh],
                       shard: Optional[nn.Module] = None) -> list:
    """Rank 0's weights on every rank of ``mesh`` (broadcast), then the
    convolutions of ``shard`` split over the model group; returns their
    names. Nothing without a mesh."""
    if mesh is None:
        return []
    for m in modules:
        mesh.broadcast_(m)
    return shard_params(shard, mesh) if shard is not None else []


class Checkpointed:
    """save / restore of ``_modules()`` (networks, optimizers, schedules:
    anything with a state_dict) and the step, as one ``ckpt_<step>.pt``.
    With a mesh, every rank calls both: a model group gathers its shards to
    full tensors for the file, rank 0 alone writes it, and every rank
    restores from it (each taking its shards)."""

    cfg: Any
    device: torch.device
    step_count: int
    mesh: Optional[TrainingMesh] = None

    def _modules(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save(self, directory: Optional[str] = None) -> str:
        """Write ``<directory or cfg.save_dir>/ckpt_<step>.pt``; returns its path."""
        directory = directory or self.cfg.save_dir
        path = os.path.abspath(os.path.join(directory, f"ckpt_{self.step_count}.pt"))
        state = {k: optimizer_state_dict(m) if isinstance(m, torch.optim.Optimizer)
                 else m.state_dict() for k, m in self._modules().items()}
        if self.mesh is None or self.mesh.is_main:
            os.makedirs(directory, exist_ok=True)
            torch.save({"step": self.step_count, **state}, path)
        if self.mesh is not None:
            self.mesh.barrier(self.device)  # the file exists before any rank returns
        return path

    def restore(self, path: str) -> None:
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        for k, m in self._modules().items():
            if isinstance(m, torch.optim.Optimizer):
                load_optimizer_state_dict(m, ckpt[k])
            else:
                m.load_state_dict(ckpt[k])
        self.step_count = int(ckpt["step"])


class STTNTrainer(Checkpointed):
    """Host loop around the GAN step: data in, the step, checkpoints out.

    ``device`` defaults to "cuda" and raises without a card; the tests pass
    "cpu". The generator (default: sttn-auto at full width, plain attention)
    and the discriminator (default nf 64, sigmoid for a non-hinge loss) start
    from a seeded flax-style init unless given. ``mesh``: a TrainingMesh
    (see the module docstring); ``device`` is then this rank's, and every
    rank builds the trainer with the same arguments. ``sharded`` names the
    generator's convolutions split over the model group. Resume restores
    both networks with their spectral-norm state, both optimizers, both
    schedules and the step (trainer_sttn.py:131-212)."""

    def __init__(self, cfg: Optional[TrainConfig] = None,
                 generator: Optional[STTNGenerator] = None,
                 discriminator: Optional[VideoDiscriminator] = None,
                 device="cuda", seed: int = 2020, mesh: Optional[TrainingMesh] = None):
        self.mesh = check_mesh(mesh)
        self.cfg = cfg or TrainConfig()
        self.device = resolve_device(device)
        if generator is None:
            # the reference trains the sttn-auto architecture at 640x120
            # (trainer_sttn.py:12,54)
            generator = STTNGenerator(variant="auto", use_kernel=False)
            init_random_(generator, seed)
        if discriminator is None:
            discriminator = VideoDiscriminator(use_sigmoid=self.cfg.gan_loss != "hinge",
                                               seed=seed + 1)
            init_random_(discriminator, seed + 1)
        self.generator = generator.to(self.device).train()
        self.discriminator = discriminator.to(self.device).train()
        self.sharded = replicate_or_shard(self.generator, self.discriminator, mesh=self.mesh,
                                          shard=self.generator)
        schedule = lr_schedule(self.cfg)
        self.gen_opt, self.gen_sched = make_optimizer(self.generator, self.cfg, schedule)
        self.dis_opt, self.dis_sched = make_optimizer(self.discriminator, self.cfg, schedule)
        self.step_fn = make_train_step(self.generator, self.discriminator, self.gen_opt,
                                       self.dis_opt, self.cfg, self.mesh)
        self.step_count = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def step(self, frames, masks) -> Dict[str, torch.Tensor]:
        """One GAN step on frames [B, T, H, W, 3] in [-1, 1] and masks
        [B, T, H, W, 1] (numpy or tensors) -> the seven metrics, detached
        0-d tensors on the device. With a mesh, B is the global batch
        (``cfg.batch_size``, as in the JAX package): every rank passes the
        same batch and steps on its slice."""
        if self.mesh is not None:
            frames, masks = self.mesh.local_batch(frames), self.mesh.local_batch(masks)
        metrics = self.step_fn(self._tensor(frames), self._tensor(masks))
        self.gen_sched.step()
        self.dis_sched.step()
        self.step_count += 1
        return metrics

    def _modules(self):
        return {"generator": self.generator, "discriminator": self.discriminator,
                "gen_opt": self.gen_opt, "dis_opt": self.dis_opt,
                "gen_sched": self.gen_sched, "dis_sched": self.dis_sched}

    # ---- validation (ref trainer valid_freq hooks) ----
    @torch.no_grad()
    def evaluate(self, frames, masks) -> Dict[str, float]:
        """PSNR / SSIM of the generator's composites on a held-out batch:
        frames [B, T, H, W, 3] in [-1, 1]; masks [B, T, H, W, 1]."""
        from vsr_tpu_torch.utils.metrics import psnr_and_ssim

        frames, masks = self._tensor(frames), self._tensor(masks)
        pred = self.generator(frames * (1 - masks), masks)
        comp = frames * (1 - masks) + pred * masks

        def u8(x):
            return torch.clamp((x + 1) * 127.5, 0, 255).cpu().numpy().astype("uint8")

        comp_u8, gt_u8 = u8(comp), u8(frames)
        psnrs, ssims = [], []
        for b in range(comp_u8.shape[0]):
            for t in range(comp_u8.shape[1]):
                p, s = psnr_and_ssim(gt_u8[b, t], comp_u8[b, t])
                if np.isfinite(p):
                    psnrs.append(p)
                    ssims.append(s)
        return {"psnr": float(np.mean(psnrs)) if psnrs else float("inf"),
                "ssim": float(np.mean(ssims)) if ssims else 1.0}

    # ---- loop ----
    def train(self, data_iter: Iterator, num_steps: int, log_cb=None) -> Dict[str, float]:
        """``num_steps`` steps over (frames, masks) batches; scalars to
        ``cfg.summary_dir`` every ``log_freq`` steps, ``log_cb(step,
        metrics)`` as often, a checkpoint every ``save_freq``. Returns the
        last step's metrics. With a mesh, scalars and ``log_cb`` are rank
        0's alone."""
        main = self.mesh is None or self.mesh.is_main
        writer = None
        if self.cfg.summary_dir and main:
            from vsr_tpu_torch.train.scalars import ScalarWriter

            writer = ScalarWriter(self.cfg.summary_dir, interval=self.cfg.log_freq)
        metrics: Dict[str, float] = {}
        try:
            for _ in range(num_steps):
                frames, masks = next(data_iter)
                metrics = as_floats(self.step(frames, masks))
                step = self.step_count
                if writer is not None:
                    writer.add_dict(metrics, step)
                if log_cb and main and step % self.cfg.log_freq == 0:
                    log_cb(step, metrics)
                if step % self.cfg.save_freq == 0:
                    self.save()
        finally:
            if writer is not None:
                writer.close()
        return metrics
