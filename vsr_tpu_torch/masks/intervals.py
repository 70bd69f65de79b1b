"""Frame-interval helpers the sttn-auto path uses (copied from
``vsr_tpu/masks/intervals.py``; the reference's
backend/tools/inpaint_tools.py:303-321).

The detection-driven modes' interval algebra (batch_generator,
expand_frame_ranges, the range finders) comes with those modes.
"""

from __future__ import annotations

from typing import Iterable, Optional


def is_frame_number_in_ab_sections(
    frame_no: int, ab_sections: Optional[Iterable[range]]
) -> bool:
    """True when frame_no falls inside any user AB section (or none are set)."""
    if not ab_sections:
        return True
    return any(frame_no in section for section in ab_sections)
