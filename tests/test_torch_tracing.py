"""The port's span layer (vsr_tpu_torch/utils/tracing.py) on the CPU, with
the narrow STTN of tests/torch_narrow.py: no span and no record_function
without a profiler, and the same frames either way; the span tree of
``process_video`` (chunk ids, parents, counts, bytes) under one; each span
beside its ``record_function`` twin in the profiler's events; one run's
spans at a time; the benchmark's five span metrics; and the operator's
export through ``device_trace`` and ``SubtitleRemover.run``."""

import json
import math
import time
from types import SimpleNamespace

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import torch_narrow
from vsr_tpu_torch import native
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint import sttn_auto, sttn_det
from vsr_tpu_torch.inpaint.engine import MAX_OVERLAPS
from vsr_tpu_torch.masks.mask import create_mask
from vsr_tpu_torch.models.sttn import STTNGenerator
from vsr_tpu_torch.utils import tracing

H, W = 180, 320
N_FRAMES = 12  # 2.4 chunks of CLIP
CLIP = 5
MASK_BOX = (40, 280, 150, 168)  # xmin, xmax, ymin, ymax
METRICS = {"read_wait_ms_per_frame": "vsr.read", "crop_resize_ms_per_frame": "vsr.crop_resize",
           "paste_ms_per_frame": "vsr.paste", "dispatch_ms_per_frame": "vsr.dispatch",
           "fetch_wait_ms_per_frame": "vsr.fetch"}


def _config():
    """Chunks of CLIP frames (stride 1, references every CLIP), fp32."""
    cfg = Config()
    cfg.compute_dtype = "float32"
    cfg.sttn_max_load_num = CLIP
    cfg.sttn_neighbor_stride = 1
    cfg.sttn_reference_length = CLIP
    return cfg


class _Reader:
    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0).copy()


class _Writer:
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame.copy())


def _frames(n, seed=0):
    base = np.random.default_rng(seed).integers(30, 220, (H, W, 3), np.uint8)
    return [np.roll(base, 5 * i, axis=1).copy() for i in range(n)]


def _mask():
    return create_mask((H, W), [MASK_BOX], 0)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def auto():
    """The narrow sttn-auto over N_FRAMES, once without a profiler and once
    under one: (inpainter, frames off, frames on, the spans, the profiler)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sttn_auto, "STTNGenerator", sttn_auto.STTNGenerator)
        torch_narrow.narrow_sttn()
        torch.manual_seed(0)
        inpainter = sttn_auto.STTNAutoInpainter(config=_config(), device="cpu")
    assert inpainter.clip_gap == CLIP
    frames, mask = _frames(N_FRAMES), _mask()

    def run():
        writer = _Writer()
        assert inpainter.process_video(_Reader(frames), writer, mask, 10**9, (W, H)) == N_FRAMES
        return writer.frames

    counted = {"spans": 0, "record_function": 0}
    span_cls, record_function = tracing.Span, torch.profiler.record_function

    class CountingSpan(span_cls):
        __slots__ = ()

        def __init__(self, *args):
            counted["spans"] += 1
            super().__init__(*args)

    def counting_record_function(*args, **kwargs):
        counted["record_function"] += 1
        return record_function(*args, **kwargs)

    before = list(tracing.spans())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "Span", CountingSpan)
        mp.setattr(torch.profiler, "record_function", counting_record_function)
        off = run()
    unchanged = tracing.spans() == before
    on, prof = _profiled(run)
    return SimpleNamespace(inpainter=inpainter, off=off, on=on, spans=list(tracing.spans()),
                           prof=prof, counted=counted, unchanged=unchanged)


def test_no_profiler_records_nothing_and_frames_are_identical(auto):
    """(a) Without a profiler: no Span made, no record_function opened,
    the span list untouched; the frames equal the profiled run's bit for
    bit."""
    assert auto.counted == {"spans": 0, "record_function": 0}
    assert auto.unchanged
    assert len(auto.off) == len(auto.on) == N_FRAMES
    for a, b in zip(auto.off, auto.on):
        np.testing.assert_array_equal(a, b)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_span_tree_per_chunk(auto):
    """(b) Under a profiler: the tree of each chunk, its chunk id on every
    span below it, the last chunk's frames and padding, the H2D and D2H
    bytes worked out from the shapes, and the native pool's workers on the
    chunk's one crop and one paste."""
    spans = auto.spans
    root, = _named(spans, "vsr.process_video")
    assert root is spans[0] and root.parent is None and root.chunk is None
    assert root.counts == {"frames": N_FRAMES}
    chunks = math.ceil(N_FRAMES / CLIP)
    sizes = [min(CLIP, N_FRAMES - k * CLIP) for k in range(chunks)]
    for name in ("vsr.read", "vsr.submit", "vsr.drain"):
        got = _named(spans, name)
        assert [s.chunk for s in got] == list(range(chunks)), name
        assert all(s.parent is root for s in got), name
    assert [s.counts["frames"] for s in _named(spans, "vsr.read")] == sizes
    assert [s.counts["frames"] for s in _named(spans, "vsr.drain")] == sizes

    engine, = auto.inpainter._engines.values()
    h, w = engine.input_hw
    wn, slots = engine.num_windows, engine.n_max + math.ceil(CLIP / engine.ref_length)
    index_bytes = wn * slots * (8 + 1) + CLIP * MAX_OVERLAPS * 8 * 2 + CLIP * 4
    h2d = CLIP * h * w * 3 + index_bytes
    r0, r1 = engine.out_rows
    d2h = CLIP * (r1 - r0) * w * 3

    parents = {"vsr.crop_resize": "vsr.submit", "vsr.dispatch": "vsr.submit",
               "vsr.stage": "vsr.dispatch", "vsr.launch": "vsr.dispatch",
               "vsr.fetch": "vsr.drain", "vsr.paste": "vsr.drain", "vsr.write": "vsr.drain"}
    for name, parent in parents.items():
        got = _named(spans, name)
        assert got, name
        for s in got:
            assert s.parent.name == parent and s.chunk == s.parent.chunk, name
            assert s.start_ns >= s.parent.start_ns and s.end_ns <= s.parent.end_ns, name
    for k, size in enumerate(sizes):
        workers = min(native.DEFAULT_THREADS, size)
        assert workers >= 1
        crop, = [s for s in _named(spans, "vsr.crop_resize") if s.chunk == k]
        assert crop.counts == {"frames": size, "bytes": size * h * w * 3, "workers": workers}
        dispatch, = [s for s in _named(spans, "vsr.dispatch") if s.chunk == k]
        assert dispatch.counts == {"frames": size, "padded": CLIP - size, "bytes": h2d}
        stage, = [s for s in _named(spans, "vsr.stage") if s.chunk == k]
        assert stage.counts == {"bytes": h2d}
        fetch, = [s for s in _named(spans, "vsr.fetch") if s.chunk == k]
        assert fetch.counts == {"bytes": d2h}
        paste, = [s for s in _named(spans, "vsr.paste") if s.chunk == k]  # one band
        assert paste.counts == {"frames": size, "workers": workers}
        per_frame = [s for s in _named(spans, "vsr.write") if s.chunk == k]
        assert [s.counts for s in per_frame] == [{"frames": 1}] * size
    assert sizes[-1] < CLIP  # the last chunk is padded


def test_det_call_reports_mask_bytes(monkeypatch):
    """(b) sttn-det's ``__call__``: its crop+resize, dispatch (the masks'
    bytes beside the frames'), fetch and paste spans."""
    monkeypatch.setattr(sttn_det, "STTNGenerator", lambda **kw: STTNGenerator(
        **kw, channel=16, stack_num=1))
    torch.manual_seed(0)
    det = sttn_det.STTNDetInpainter(config=_config(), device="cpu")
    frames = _frames(3)

    def batch():  # as the pipeline calls it: under one outermost span
        with tracing.span("vsr.inpaint_batch", frames=3):
            return det([f.copy() for f in frames], _mask())

    out, _ = _profiled(batch)
    assert len(out) == 3
    spans = tracing.spans()
    engine, = det._engines.values()
    h, w = engine.input_hw
    crop, = _named(spans, "vsr.crop_resize")
    assert crop.counts == {"frames": 3, "bytes": 3 * h * w * 3}
    dispatch, = _named(spans, "vsr.dispatch")
    clip = engine.clip_len
    index_bytes = (engine.num_windows * (engine.n_max + math.ceil(clip / engine.ref_length))
                   * (8 + 1) + clip * MAX_OVERLAPS * 8 * 2 + clip * 4)
    assert dispatch.counts == {"frames": 3, "padded": clip - 3,
                               "bytes": clip * h * w * 3 + clip * h * w + index_bytes}
    assert len(_named(spans, "vsr.fetch")) == 1
    paste, = _named(spans, "vsr.paste")  # the band's frames in one native call
    assert paste.counts == {"frames": 3, "workers": min(native.DEFAULT_THREADS, 3)}


def test_spans_sit_on_their_record_function_twins(auto):
    """(c) Every vsr.* span within 1 ms of its record_function event, on
    the profiler's own clock."""
    events = [e for e in auto.prof.profiler.kineto_results.events()
              if e.name().startswith("vsr.")]
    names = sorted({s.name for s in auto.spans})
    assert names == sorted({e.name() for e in events})
    for name in names:
        spans = _named(auto.spans, name)
        twins = sorted((e for e in events if e.name() == name), key=lambda e: e.start_ns())
        assert len(spans) == len(twins), name
        for s, e in zip(spans, twins):
            assert abs(s.start_ns - e.start_ns()) < 1_000_000, name
            assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) < 1_000_000, name


def test_an_outermost_span_clears_the_last_run():
    """(d) Spans accumulate below an open span; the next outermost one
    starts a new list."""
    def first():
        with tracing.span("a", chunk=3, frames=2) as a:
            with tracing.span("b") as b:
                b.add(bytes=5)
                b.add(bytes=5)
        return a, b

    (a, b), _ = _profiled(first)
    assert tracing.spans() == [a, b]
    assert b.parent is a and b.chunk == 3 and b.counts == {"bytes": 10}
    assert a.counts == {"frames": 2}
    (c, d), _ = _profiled(first)
    assert tracing.spans() == [c, d] and c is not a


def test_stage_timer_sums_self_time_and_counts():
    """StageTimer over recorded spans: self time is a span less its
    children; counts are summed per name."""
    def run():
        with tracing.span("outer"):
            for _ in range(2):
                with tracing.span("inner", frames=3):
                    time.sleep(0.002)

    _profiled(run)
    outer, i1, i2 = tracing.spans()
    summary = tracing.StageTimer(tracing.spans()).summary()
    assert summary["inner"]["count"] == 2 and summary["inner"]["counts"] == {"frames": 6}
    want_self = (outer.end_ns - outer.start_ns - (i1.end_ns - i1.start_ns)
                 - (i2.end_ns - i2.start_ns)) / 1e9
    assert summary["outer"]["self_s"] == round(want_self, 4)
    assert summary["inner"]["self_s"] == summary["inner"]["total_s"]
    assert "self" in tracing.StageTimer(tracing.spans()).report()


def _load_metric(name):
    from perfbench import harness

    return harness.load_module(f"{harness.BENCH_DIR}/metrics/{name}.py")


def test_span_metrics_read_sums_per_frame_on_a_card_only():
    """(e) Each of the five metrics: 1000 × Σ seconds of its spans over the
    frames where the card is a gpu and a vsr.process_video span was
    recorded; None on a cpu, and None without that span."""
    def window():
        with tracing.span("vsr.process_video"):
            for name in METRICS.values():
                for _ in range(2):
                    with tracing.span(name):
                        time.sleep(0.001)

    _profiled(window)
    spans = tracing.spans()
    gpu = SimpleNamespace(card={"platform": "gpu", "kind": "NVIDIA H100"}, frames=7)
    cpu = SimpleNamespace(card={"platform": "cpu", "kind": "cpu"}, frames=7)
    for metric, name in METRICS.items():
        reader = _load_metric(metric)
        want = sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e6 / 7
        assert reader.read(gpu) == pytest.approx(want, rel=1e-12) and want >= 2 / 7, metric
        assert reader.read(cpu) is None, metric
    def other():
        with tracing.span("vsr.read"):
            pass

    _profiled(other)  # an outermost span: the window's spans are gone
    for metric in METRICS:
        assert _load_metric(metric).read(gpu) is None, metric


def test_device_trace_exports_spans(monkeypatch, tmp_path):
    """(f) With VSR_TRACE_DIR: trace.json holds vsr.process_video, and
    spans.json every span with parents, chunks and counts, and the
    summary; the report goes to the log."""
    monkeypatch.setenv("VSR_TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(sttn_auto, "STTNGenerator", sttn_auto.STTNGenerator)
    torch_narrow.narrow_sttn()
    inpainter = sttn_auto.STTNAutoInpainter(config=_config(), device="cpu")
    logs = []
    with tracing.device_trace("run", log=logs.append):
        inpainter.process_video(_Reader([]), _Writer(), _mask(), 10**9, (W, H))
    with open(tmp_path / "run" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "vsr.process_video" for e in events)
    with open(tmp_path / "run" / "spans.json") as f:
        exported = json.load(f)
    assert [(s["name"], s["parent"], s["chunk"], s["counts"]) for s in exported["spans"]] == [
        ("vsr.process_video", None, None, {"frames": 0}), ("vsr.read", 0, 0, {"frames": 0})]
    assert exported["summary"]["vsr.read"]["count"] == 1
    assert len(logs) == 1 and "vsr.process_video" in logs[0]


def test_run_exports_its_spans(monkeypatch, tmp_path):
    """(f) ``SubtitleRemover.run`` in sttn-auto mode under VSR_TRACE_DIR:
    vsr.run is the root, vsr.process_video and vsr.mux its children, and
    the summary reaches the run's log."""
    from vsr_tpu_torch.pipeline import SubtitleRemover

    video = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
    for frame in _frames(3):
        writer.write(frame)
    writer.release()
    monkeypatch.setenv("VSR_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setattr(sttn_auto, "STTNGenerator", sttn_auto.STTNGenerator)
    torch_narrow.narrow_sttn()
    remover = SubtitleRemover(video, str(tmp_path / "out.mp4"), sub_areas=[(150, 168, 40, 280)],
                              config=_config(), device="cpu")
    logs = []
    remover.append_output = lambda *a: logs.append(" ".join(str(x) for x in a))
    remover.run()
    with open(tmp_path / "trace" / "run" / "spans.json") as f:
        spans = json.load(f)["spans"]
    assert spans[0]["name"] == "vsr.run" and spans[0]["parent"] is None
    children = [s["name"] for s in spans if s["parent"] == 0]
    assert children == ["vsr.process_video", "vsr.mux"]
    assert "vsr.run" in logs[-1] and "vsr.paste" in logs[-1]
