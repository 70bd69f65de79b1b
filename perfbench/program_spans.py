"""Host time per frame from the program's own spans
(``vsr_tpu_torch/utils/tracing.py``: ``spans()``, recorded while the traced
run's profiler records; the window's outermost span is
``vsr.process_video``), for the metrics whose source is ``program_span``."""

from __future__ import annotations

WINDOW = "vsr.process_video"


def ms_per_frame(ctx, name: str):
    """1000 × the summed seconds of the spans named ``name`` over the
    frames the window returned. None off a card (the plain route computes
    inside ``dispatch`` there, so the number would measure something
    else), and where the program recorded no ``vsr.process_video`` span or
    records no spans at all."""
    if ctx.card.get("platform") != "gpu" or not ctx.frames:
        return None
    from vsr_tpu_torch.utils import tracing

    recorded = getattr(tracing, "spans", None)
    if recorded is None:
        return None
    spans = [s for s in recorded() if s.end_ns is not None]
    if not any(s.name == WINDOW for s in spans):
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == name)
    return ns / 1e6 / ctx.frames
