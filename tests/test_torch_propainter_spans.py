"""The ProPainter spans (vsr_tpu_torch/inpaint/propainter.py) and the
device-time form of the port's span layer (vsr_tpu_torch/utils/tracing.py)
on the CPU:

* with no profiler recording, ``span`` and ``device_span`` give the one
  shared no-op object and record nothing;
* under a profiler, ``device_span`` records as ``span`` does, and on the
  CPU carries no device time;
* a ``__call__`` of a narrow inpainter under a profiler records
  ``vsr.pp.clip`` over the six stage spans with their counts (the staging
  buffers made on the first clip and reused on the second, the pool
  workers that cropped and composed), and returns the frames it returns
  without one;
* importing the ProPainter mode and running one ``__call__`` leaves torch's
  global settings (TF32, cuDNN's autotuner and determinism, the float32
  matmul precision, the default dtype) as they were.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_propainter_reference import CFG, call_frames, port_inpainter
from perfbench.weights_propainter import make_weights
from vsr_tpu_torch import native
from vsr_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parent.parent
STAGES = ("vsr.pp.prepare", "vsr.pp.flows", "vsr.pp.complete", "vsr.pp.propagate",
          "vsr.pp.sweep", "vsr.pp.finish")


def test_no_profiler_no_record_for_either_form():
    before = list(tracing.spans())
    off = tracing.span("a")
    assert tracing.device_span("b", "cpu") is off
    assert tracing.device_span("c", torch.device("cuda", 0), frames=3) is off
    with tracing.device_span("d", "cuda:0") as s:
        s.add(frames=1)
    tracing.resolve_device_times()
    assert tracing.spans() == before and not tracing._pending


def test_device_span_on_cpu_records_as_span():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with tracing.device_span("inner", "cpu", frames=2) as s:
                s.add(frames=1)
    tracing.resolve_device_times()
    outer, inner = tracing.spans()
    assert (inner.name, inner.parent, inner.counts) == ("inner", outer, {"frames": 3})
    assert inner.end_ns >= inner.start_ns and not tracing._pending


def test_call_records_the_clip_and_its_stages(tmp_path):
    """Two traced clips and an untraced one of the same frames: the same
    bytes; each traced clip's spans and counts, the staging buffers made
    on the first clip (``staged`` 0) and reused on the second (1), and the
    pool workers that cropped and composed."""
    port = port_inpainter(make_weights(CFG, 7, "cpu"), str(tmp_path))
    frames, mask = call_frames()
    runs = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            traced = port([f.copy() for f in frames], mask)
        runs.append((traced, list(tracing.spans())))
    plain = port([f.copy() for f in frames], mask)
    workers = min(native.DEFAULT_THREADS, 10)
    for staged, (traced, spans) in enumerate(runs):
        assert all(np.array_equal(a, b) for a, b in zip(plain, traced))
        clip = spans[0]
        assert clip.name == "vsr.pp.clip" and clip.parent is None
        assert clip.counts == {"frames": 10, "band_px": 40 * 216}
        assert {s.name for s in spans[1:]} == set(STAGES)
        assert all(s.parent is clip or s.parent.parent is clip for s in spans[1:])
        by_name = {s.name: s for s in spans}
        assert by_name["vsr.pp.flows"].counts == {"pairs": 9, "pair_chunks": 1}
        assert by_name["vsr.pp.complete"].counts == {"subvideos": 2}
        sweep = by_name["vsr.pp.sweep"].counts
        assert sweep["windows"] == 5 and 0 < sweep["masked_windows"] <= sweep["attention_windows"]
        assert [s.counts for s in spans if s.name == "vsr.pp.prepare" and s.counts] == [
            {"frames": 10, "workers": workers, "staged": staged}]
        assert [s.counts for s in spans if s.name == "vsr.pp.finish"] == [
            {"frames": 10, "workers": workers}]
        assert all("device_ns" not in s.counts for s in spans)  # no card


STATE = """
import torch
def state():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
            torch.get_float32_matmul_precision(), torch.get_default_dtype())
before = state()
import numpy as np
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint.propainter import PropainterInpainter
from vsr_tpu_torch.masks.mask import create_mask
config = Config(compute_dtype="bfloat16", propainter_raft_iters=1)
inp = PropainterInpainter(None, config, dict(channel=16, hidden=32, depths=2, n_head=2,
                                             window_size=(3, 4), pool_size=(2, 2)),
                          dict(hidden=32, context=32, corr_levels=2, corr_radius=2),
                          device="cpu")
frames = [np.full((72, 216, 3), i * 20, np.uint8) for i in range(4)]
out = inp(frames, create_mask((72, 216), [(32, 183, 63, 71)], 10))
assert len(out) == 4
print(before == state(), before, state())
"""


def test_propainter_leaves_torch_settings_alone():
    out = subprocess.run([sys.executable, "-c", STATE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("True"), out.stdout
