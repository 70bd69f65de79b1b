"""Per-stage timing and device tracing.

A copy of ``vsr_tpu/utils/tracing.py``, with torch.profiler in place of
jax.profiler:

* ``StageTimer`` — lightweight named-span accumulator for the host pipeline
  (decode / preprocess / device / composite / encode);
* ``device_trace`` — context manager around ``torch.profiler`` (CPU and, with
  a card, CUDA activities) writing a Chrome trace to
  ``$VSR_TRACE_DIR/<label>/trace.json`` when VSR_TRACE_DIR is set (no-op
  otherwise, so it can wrap the hot loop unconditionally).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(1, self.counts[name]), 2),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = []
        for name, row in sorted(self.summary().items(),
                                key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:<24} {row['total_s']:>8.2f}s  x{row['count']:<5} "
                f"({row['mean_ms']:.1f} ms/op)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(label: str = "vsr") -> Iterator[None]:
    """Wrap a region in a torch.profiler trace when VSR_TRACE_DIR is set."""
    trace_dir = os.environ.get("VSR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, label)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
