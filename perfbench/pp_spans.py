"""Per-frame times from the port's ProPainter spans
(``vsr_tpu_torch/inpaint/propainter.py``: ``vsr.pp.clip`` around each
``__call__`` over ``vsr.pp.prepare``, ``vsr.pp.flows``, ``vsr.pp.complete``,
``vsr.pp.propagate``, ``vsr.pp.sweep`` and ``vsr.pp.finish``), for the
metrics of the ProPainter cell whose source is ``program_span``.

Each ``__call__`` opens ``vsr.pp.clip`` as its outermost span, which starts
a new run of spans (``tracing.spans()`` holds one run), so the driver hands
each clip's spans to ``collect()`` as the clip returns, and ``reset()``s at
the window's start. ``program_spans.py`` reads the STTN cells' spans under
``vsr.process_video``, which this path does not open."""

from __future__ import annotations

from typing import Iterable, List

CLIP = "vsr.pp.clip"

_clips: List[list] = []


def reset() -> None:
    _clips.clear()


def collect() -> None:
    """Keeps the spans of the clip that has just returned, if the program
    records ProPainter spans (a traced run's, on a program that has them)."""
    from vsr_tpu_torch.utils import tracing

    recorded = getattr(tracing, "spans", None)
    if recorded is None:
        return
    spans = [s for s in recorded() if s.end_ns is not None]
    if any(s.name == CLIP for s in spans):
        _clips.append(spans)


def ms_per_frame(ctx, names: Iterable[str], device: bool = False):
    """1000 × the summed seconds of the spans named one of ``names`` over
    the frames the window returned: their device time (``device_ns``, from
    CUDA events) with ``device``, else their host time. None off a card,
    where no clip's spans were collected, and where a span lacks its device
    time."""
    if ctx.card.get("platform") != "gpu" or not ctx.frames or not _clips:
        return None
    names = set(names)
    spans = [s for clip in _clips for s in clip if s.name in names]
    if not spans:
        return None
    if device:
        times = [s.counts.get("device_ns") for s in spans]
        if any(t is None for t in times):
            return None
        ns = sum(times)
    else:
        ns = sum(s.end_ns - s.start_ns for s in spans)
    return ns / 1e6 / ctx.frames
