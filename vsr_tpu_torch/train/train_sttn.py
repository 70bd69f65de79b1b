"""STTN training CLI: counterpart of ``vsr_tpu/train/train_sttn.py`` (the
reference's backend/tools/train/train_sttn.py:16-96), on one device.

Usage:
  python -m vsr_tpu_torch.train.train_sttn --data <frames_root> [--config cfg.json]
      [--steps N] [--save-dir DIR] [--resume CKPT] [--device cuda]

``--device`` defaults to cuda and fails without a card; ``--device cpu``
trains on the CPU. ``--distributed`` (multi-GPU data parallelism) is not
ported yet: ROADMAP item 10.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train STTN on one device")
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
                        help="Data-parallel training over several GPUs (not ported yet)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.distributed:
        raise SystemExit("--distributed: data-parallel training is not ported yet "
                         "(ROADMAP item 10, DDP)")

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

    trainer = STTNTrainer(cfg, device=args.device)
    if args.resume:
        trainer.restore(args.resume)

    def log(step, metrics):
        line = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"[{step}] {line}", flush=True)

    remaining = cfg.iterations - trainer.step_count
    trainer.train(dataset.batches(cfg.batch_size), remaining, log_cb=log)
    path = trainer.save()
    print(f"final checkpoint: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
