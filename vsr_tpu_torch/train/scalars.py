"""Training scalar summaries (the reference's tensorboard writer analog): a
copy of ``vsr_tpu/train/scalars.py``.

The reference trainers write gen/dis scalars through tensorboardX every 100
iterations (backend/tools/train/trainer_sttn.py:96-128,
video/core/trainer.py:120-199). Here scalars always append to a JSONL file
(greppable, no deps) and mirror into tensorboard(X) when either package is
importable — this environment has neither, so JSONL is the contract tests
pin.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


def _tb_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter  # type: ignore
        return SummaryWriter(log_dir)
    except Exception:
        pass
    try:
        from tensorboardX import SummaryWriter  # type: ignore
        return SummaryWriter(log_dir)
    except Exception:
        return None


class ScalarWriter:
    """Append-only scalar log: {"step": n, "tag": ..., "value": ..., "t": ...}.

    Like the reference's add_summary (trainer_sttn.py:120-126), callers gate
    writes on an interval; ``interval`` here makes that the writer's job:
    add() drops values unless step % interval == 0 (interval 1 = keep all).
    """

    def __init__(self, log_dir: str, interval: int = 100):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self.interval = max(1, interval)
        self._fh = open(self.path, "a", buffering=1)
        self._tb = _tb_writer(log_dir)

    def add(self, tag: str, value: float, step: int) -> None:
        if step % self.interval:
            return
        self._fh.write(json.dumps(
            {"step": int(step), "tag": tag, "value": float(value),
             "t": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_dict(self, metrics, step: int, prefix: str = "loss/") -> None:
        for k, v in metrics.items():
            self.add(f"{prefix}{k}", float(v), step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
