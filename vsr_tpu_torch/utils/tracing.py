"""Spans of the port's host work, their per-name aggregate, and the
operator's trace exporter.

* ``span(name, chunk=None, **counts)`` — a context manager around one step
  of host work. It records only while a torch profiler is recording,
  whoever started it (a benchmark's traced run, ``device_trace``); then it
  also opens a ``torch.profiler.record_function`` of the same name, so the
  step shows in the profiler's trace. Otherwise it is one check of the
  profiler's state and nothing else: no record, no clock read.
* ``device_span(name, device, chunk=None, **counts)`` — a span that, on a
  CUDA device and only while a profiler records, also records a CUDA event
  on the device's current stream at its opening and at its closing, so
  that it carries the device time of the work enqueued while it was open;
  ``resolve_device_times()`` turns the events of the spans closed since
  its last call into ``counts["device_ns"]`` once the device has done that
  work (after a synchronising copy; it adds no synchronisation of its
  own). Otherwise it is ``span``.
* ``spans()`` — the spans recorded since the last outermost span opened
  (one that opened while no other span was open in any thread): one run.
  Times are ``time.time_ns()``, the Unix-nanosecond epoch of the
  profiler's own events, so every span can be set against every device op.
* ``StageTimer`` — the per-name aggregate of spans (count, total and self
  seconds, summed counts); ``StageTimer(spans())`` sums a recorded run, and
  its own ``span(name)`` times a step whether or not a profiler records.
* ``device_trace(label, log=None)`` — with VSR_TRACE_DIR set, profiles the
  region (CPU and, with a card, CUDA) and writes
  ``$VSR_TRACE_DIR/<label>/trace.json`` (Chrome format, with the spans in
  it) and ``spans.json`` (every span, and the StageTimer summary), and
  passes ``StageTimer.report()`` to ``log``; a no-op otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import torch
from torch._C._autograd import _profiler_enabled


class Span:
    """One step of host work: ``name``, ``start_ns`` / ``end_ns``
    (``time.time_ns()``; ``end_ns`` is None while open), ``parent`` (the span
    of the same thread still open when it opened, or None), ``chunk`` (given,
    or the parent's) and ``counts`` (name -> number, known at the step's
    boundary; ``add`` sums more in while it is open)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "chunk", "counts")

    def __init__(self, name: str, parent: Optional["Span"], chunk: Optional[int],
                 counts: Dict[str, int]) -> None:
        self.name, self.parent, self.counts = name, parent, counts
        self.chunk = chunk if chunk is not None or parent is None else parent.chunk
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None

    def add(self, **counts: int) -> None:
        for key, value in counts.items():
            self.counts[key] = self.counts.get(key, 0) + value


class _Off:
    """What ``span`` gives while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, **counts: int) -> None:
        return None


_OFF = _Off()

_recorded: List[Span] = []
_open_count = 0  # spans open in every thread
_local = threading.local()  # .stack: the spans open in this thread


class _Recording:
    """An open span while the profiler records."""

    __slots__ = ("span", "_rf")

    def __init__(self, name: str, chunk: Optional[int], counts: Dict[str, int]) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if not _open_count:
            _recorded.clear()  # a new run: memory is bounded by one
        self.span = Span(name, stack[-1] if stack else None, chunk, counts)
        self._rf = torch.profiler.record_function(name)

    def __enter__(self) -> Span:
        global _open_count
        _local.stack.append(self.span)
        _open_count += 1
        _recorded.append(self.span)
        self._rf.__enter__()
        return self.span

    def __exit__(self, *exc) -> None:
        global _open_count
        self._rf.__exit__(*exc)
        self.span.end_ns = time.time_ns()
        _local.stack.pop()
        _open_count -= 1


def span(name: str, chunk: Optional[int] = None, **counts: int):
    """A context manager that records the step ``name`` while a torch
    profiler records (see the module's docstring); it yields the Span, or
    an object whose ``add`` does nothing."""
    if not _profiler_enabled():
        return _OFF
    return _Recording(name, chunk, counts)


class _DeviceRecording(_Recording):
    """An open span that also records a CUDA event at each of its edges."""

    __slots__ = ("_stream", "_start")

    def __init__(self, name: str, chunk: Optional[int], counts: Dict[str, int],
                 device: torch.device) -> None:
        super().__init__(name, chunk, counts)
        self._stream = torch.cuda.current_stream(device)

    def __enter__(self) -> Span:
        span = super().__enter__()
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)
        return span

    def __exit__(self, *exc) -> None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        _pending.append((self.span, self._start, end))
        super().__exit__(*exc)


# (span, start event, end event) of the device spans not yet resolved
_pending: List[tuple] = []


def device_span(name: str, device, chunk: Optional[int] = None, **counts: int):
    """``span`` that also times, on a CUDA ``device``, the device work
    enqueued while it is open (see the module's docstring). Without a
    profiler recording it is the same one check as ``span``."""
    if not _profiler_enabled():
        return _OFF
    device = torch.device(device)
    if device.type != "cuda":
        return _Recording(name, chunk, counts)
    return _DeviceRecording(name, chunk, counts, device)


def resolve_device_times() -> None:
    """Sets ``counts["device_ns"]`` of every device span closed since the
    last call whose closing event the device has reached (``Event.query``,
    which does not wait); the others stay pending."""
    still = []
    for span, start, end in _pending:
        if end.query():
            span.counts["device_ns"] = int(round(start.elapsed_time(end) * 1e6))
        else:
            still.append((span, start, end))
    _pending[:] = still


def spans() -> List[Span]:
    """The spans of the current run, in the order they opened."""
    return _recorded


class StageTimer:
    """Per-name aggregate of spans: count, total seconds, self seconds (a
    span less what its children cover) and summed counts."""

    def __init__(self, recorded: Iterable[Span] = ()) -> None:
        self.spans: List[Span] = list(recorded)
        self._stack: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[Span]:
        """Times one step into this timer, whether or not a profiler records."""
        s = Span(name, self._stack[-1] if self._stack else None, None, {})
        self.spans.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.end_ns = time.time_ns()
            self._stack.pop()

    def summary(self) -> Dict[str, Dict[str, object]]:
        closed = [s for s in self.spans if s.end_ns is not None]
        covered: Dict[int, int] = defaultdict(int)
        for s in closed:
            if s.parent is not None:
                covered[id(s.parent)] += s.end_ns - s.start_ns
        rows: Dict[str, Dict[str, object]] = {}
        for s in closed:
            row = rows.setdefault(s.name, {"total_ns": 0, "self_ns": 0, "count": 0,
                                           "counts": defaultdict(int)})
            row["total_ns"] += s.end_ns - s.start_ns
            row["self_ns"] += s.end_ns - s.start_ns - covered[id(s)]
            row["count"] += 1
            for key, value in s.counts.items():
                row["counts"][key] += value
        return {
            name: {
                "total_s": round(row["total_ns"] / 1e9, 4),
                "self_s": round(row["self_ns"] / 1e9, 4),
                "count": row["count"],
                "mean_ms": round(row["total_ns"] / 1e6 / row["count"], 2),
                "counts": dict(row["counts"]),
            }
            for name, row in rows.items()
        }

    def report(self) -> str:
        lines = []
        for name, row in sorted(self.summary().items(),
                                key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:<24} {row['total_s']:>8.2f}s  self {row['self_s']:>8.2f}s  "
                f"x{row['count']:<5} ({row['mean_ms']:.1f} ms/op)"
            )
        return "\n".join(lines)


def _spans_json(recorded: List[Span]) -> dict:
    """Every span (parents as indices into the list) and their summary."""
    index = {id(s): i for i, s in enumerate(recorded)}
    return {
        "clock": "time.time_ns (Unix ns, the profiler's epoch)",
        "spans": [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
                   "parent": index.get(id(s.parent)), "chunk": s.chunk, "counts": s.counts}
                  for s in recorded],
        "summary": StageTimer(recorded).summary(),
    }


@contextlib.contextmanager
def device_trace(label: str = "vsr",
                 log: Optional[Callable[[str], None]] = None) -> Iterator[None]:
    """Profile a region when VSR_TRACE_DIR is set (see the module's
    docstring); a no-op otherwise, so it can wrap a whole run."""
    trace_dir = os.environ.get("VSR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, label)
    os.makedirs(out_dir, exist_ok=True)
    started_ns = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    recorded = [s for s in spans() if s.start_ns >= started_ns]
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump(_spans_json(recorded), f)
    if log is not None and recorded:
        log(StageTimer(recorded).report())
