"""How far two STTN training runs on one NVIDIA GPU part, step by step.

    python3 scripts/train_divergence.py      (from the repository root)

chip_smoke phase s1's trainer (TrainConfig() defaults: sttn-auto 640x120,
channel 256, 8 blocks, global batch 8 of 5 frames, fp32, TF32 off, cuDNN
deterministic) takes three steps on the same seeded batches in four runs:

* A: one process;
* B: one process again, from the same init and data;
* ranks: two gloo ranks sharing cuda:0, 4 samples each, free-running;
* ranks from A: the same, each step restored from A's state before it
  (chip_smoke's check).

For B and both rank runs it prints, with the card's name and power limit,
each step's largest relative loss difference from A (and the loss), and
the largest generator parameter difference after the last step. Needs one
CUDA device; imports nothing of jax or vsr_tpu.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

STEPS = 3


def settings():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def rank_run(rank, out_dir, states):
    from vsr_tpu_torch.parallel.distributed import TrainingMesh, init_distributed
    from vsr_tpu_torch.train.sttn_trainer import TrainConfig

    settings()
    dev = init_distributed("cuda:0")
    run = cs.s_sttn(dev, TrainingMesh(), TrainConfig().batch_size, STEPS, states)
    if rank != 0:
        run.pop("params")
    torch.save(run, os.path.join(out_dir, f"rank{rank}.pt"))


def ranks(tmp, name, states):
    out_dir = os.path.join(tmp, name)
    os.makedirs(out_dir)
    cs.spawn_ranks(2, rank_run, out_dir, states)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
            for r in range(2)]


def against(ref, runs):
    """Each step's largest relative loss difference of ``runs`` from ``ref``
    (and which loss), and the largest generator parameter difference."""
    by_step = []
    for i, want in enumerate(ref["losses"]):
        rel, key = max((abs(run["losses"][i][k] - want[k]) / max(abs(want[k]), 1e-12), k)
                       for run in runs for k in want)
        by_step.append({"rel": rel, "loss": key})
    return {"by_step": by_step, "param_max_diff": cs.max_param_diff(runs[0]["params"],
                                                                    ref["params"])}


def main():
    from vsr_tpu_torch.train.sttn_trainer import TrainConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    settings()
    dev, batch = torch.device("cuda", 0), TrainConfig().batch_size
    tmp = tempfile.mkdtemp(prefix="train_divergence_")
    try:
        states = os.path.join(tmp, "states")
        a = cs.s_sttn(dev, None, batch, STEPS, states)
        b = cs.s_sttn(dev, None, batch, STEPS)
        torch.cuda.empty_cache()
        result = {"card": card, "B": against(a, [b]),
                  "ranks": against(a, ranks(tmp, "free", None)),
                  "ranks from A": against(a, ranks(tmp, "synced", states))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("B", "ranks", "ranks from A"):
        r = result[name]
        steps = ", ".join(f"{s['rel']:.3g} ({s['loss']})" for s in r["by_step"])
        print(f"{name} against A: losses within {steps} relative by step; largest generator "
              f"parameter difference after step {STEPS} {r['param_max_diff']:.3g} on {card}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
