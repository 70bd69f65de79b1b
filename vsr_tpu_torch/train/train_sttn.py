"""STTN training CLI: counterpart of ``vsr_tpu/train/train_sttn.py`` (the
reference's backend/tools/train/train_sttn.py:16-96).

Usage:
  python -m vsr_tpu_torch.train.train_sttn --data <frames_root> [--config cfg.json]
      [--steps N] [--save-dir DIR] [--resume CKPT] [--device cuda]
  torchrun --nproc_per_node=N -m vsr_tpu_torch.train.train_sttn --distributed --data ...

``--device`` defaults to cuda and fails without a card; ``--device cpu``
trains on the CPU. Without ``--distributed`` it trains on that one device.
``--distributed`` joins torchrun's process group (``init_distributed``: a
bare cuda is cuda:LOCAL_RANK over NCCL, cpu is gloo) and trains data-parallel
over every process, as the JAX package's ``create_mesh()`` spans every
device: ``batch_size`` is the global batch, every rank draws the same
batches from the dataset's seed and steps on its slice, rank 0 logs and
writes the checkpoints, every rank restores ``--resume``. Without torchrun's
environment it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train STTN on one device or, under "
                                     "torchrun, data-parallel over its processes")
    parser.add_argument("--data", required=True,
                        help="Root of training videos (zips or frame dirs)")
    parser.add_argument("--config", default=None, help="TrainConfig JSON")
    parser.add_argument("--steps", type=int, default=None,
                        help="Override iteration count")
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--resume", default=None,
                        help="Checkpoint path to resume from")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    parser.add_argument("--distributed", action="store_true",
                        help="Data-parallel training over torchrun's processes")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.distributed:
        return train(args, args.device)
    import torch.distributed as dist

    from vsr_tpu_torch.parallel.distributed import TrainingMesh, init_distributed

    joined = not dist.is_initialized()  # this call owns the group it creates
    device = init_distributed(args.device)
    try:
        return train(args, device, TrainingMesh())
    finally:
        if joined:
            dist.destroy_process_group()


def train(args, device, mesh=None) -> int:
    """Train as the arguments say on ``device`` (with a mesh, as this rank)."""
    from vsr_tpu_torch.train.dataset import FrameSequenceDataset
    from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig

    cfg = TrainConfig()
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
        cfg = dataclasses.replace(cfg, **overrides)
    if args.steps is not None:
        cfg = dataclasses.replace(cfg, iterations=args.steps)
    if args.save_dir:
        cfg = dataclasses.replace(cfg, save_dir=args.save_dir)

    dataset = FrameSequenceDataset(
        args.data, frame_w=cfg.frame_w, frame_h=cfg.frame_h,
        sample_length=cfg.sample_length)

    trainer = STTNTrainer(cfg, device=device, mesh=mesh)
    if args.resume:
        trainer.restore(args.resume)

    def log(step, metrics):
        line = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"[{step}] {line}", flush=True)

    remaining = cfg.iterations - trainer.step_count
    trainer.train(dataset.batches(cfg.batch_size), remaining, log_cb=log)
    path = trainer.save()
    if mesh is None or mesh.is_main:
        print(f"final checkpoint: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
