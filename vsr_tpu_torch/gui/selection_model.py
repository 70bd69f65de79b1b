"""Python mirror of gui/selection.js — the selection-canvas geometry.

The browser GUI's rect state machine and coordinate transforms (reference:
ui/component/video_display_component.py:686-812) live in gui/selection.js;
this module reimplements them function-for-function so the logic runs under
pytest (no JS engine ships in this environment). A copy of
``vsr_tpu/gui/selection_model.py``: tests/test_torch_gui_selection.py drives
it through the same unit vectors as tests/test_gui_selection.py and holds it
to gui/selection_vectors.json, the committed contract a node-based JS test
can consume to pin selection.js to the same behavior.

Rects are ``[y0, y1, x0, x1]`` in VIDEO pixel coordinates; ``info`` is
``(width, height)`` of the video; a drag is a dict
``{k, mode, ox, oy, w, h}``. ``round`` here is JS ``Math.round``
(half-away-from-zero for positive values), not python banker's rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

HANDLE = 12   # resize-handle hit radius, canvas px (scaled to video px)
MIN_SIZE = 4  # rects thinner than this on release are discarded

Rect = List[float]


def _js_round(v: float) -> int:
    """JS Math.round: half always rounds UP (toward +inf)."""
    import math

    return int(math.floor(v + 0.5))


def canvas_pos(client_x: float, client_y: float,
               bounds: Dict[str, float],
               canvas_w: float, canvas_h: float) -> Tuple[float, float]:
    """Client event -> canvas bitmap coords (CSS scaling of the element)."""
    return ((client_x - bounds["left"]) * canvas_w / bounds["width"],
            (client_y - bounds["top"]) * canvas_h / bounds["height"])


def scale_xy(info: Tuple[float, float],
             canvas_w: float, canvas_h: float) -> Tuple[float, float]:
    """Canvas bitmap -> video coords scale (preview may be downscaled)."""
    return info[0] / canvas_w, info[1] / canvas_h


def begin_drag(rects: List[Rect], vx: float, vy: float,
               sx: float, sy: float) -> Tuple[List[Rect], Dict]:
    """mousedown: resize-handle hit beats body hit, topmost rect wins,
    otherwise start a new rect."""
    rects = [list(r) for r in rects]
    for k in range(len(rects) - 1, -1, -1):
        y0, y1, x0, x1 = rects[k]
        if abs(vx - x1) < HANDLE * sx and abs(vy - y1) < HANDLE * sy:
            return rects, {"k": k, "mode": "resize"}
        if x0 <= vx <= x1 and y0 <= vy <= y1:
            return rects, {"k": k, "mode": "move", "ox": vx - x0,
                           "oy": vy - y0, "w": x1 - x0, "h": y1 - y0}
    rects.append([vy, vy, vx, vx])
    return rects, {"k": len(rects) - 1, "mode": "resize"}


def apply_drag(rects: List[Rect], drag: Dict, vx: float, vy: float,
               info: Tuple[float, float]) -> List[Rect]:
    """mousemove: pointer clamps to the video bounds; moves clamp the whole
    rect inside."""
    rects = [list(r) for r in rects]
    width, height = info
    vx = max(0.0, min(width, vx))
    vy = max(0.0, min(height, vy))
    r = rects[drag["k"]]
    if drag["mode"] == "resize":
        r[1] = _js_round(vy)
        r[3] = _js_round(vx)
    else:
        x0 = max(0.0, min(width - drag["w"], vx - drag["ox"]))
        y0 = max(0.0, min(height - drag["h"], vy - drag["oy"]))
        rects[drag["k"]] = [_js_round(y0), _js_round(y0 + drag["h"]),
                            _js_round(x0), _js_round(x0 + drag["w"])]
    return rects


def end_drag(rects: List[Rect], drag: Dict) -> List[Rect]:
    """mouseup: normalize corners; degenerate rects are dropped."""
    rects = [list(r) for r in rects]
    y0, y1, x0, x1 = rects[drag["k"]]
    rects[drag["k"]] = [min(y0, y1), max(y0, y1), min(x0, x1), max(x0, x1)]
    ny0, ny1, nx0, nx1 = rects[drag["k"]]
    if ny1 - ny0 < MIN_SIZE or nx1 - nx0 < MIN_SIZE:
        rects.pop(drag["k"])
    return rects


def remove_at(rects: List[Rect], vx: float, vy: float) -> List[Rect]:
    """dblclick: remove the topmost rect containing the point."""
    rects = [list(r) for r in rects]
    for k in range(len(rects) - 1, -1, -1):
        y0, y1, x0, x1 = rects[k]
        if x0 <= vx <= x1 and y0 <= vy <= y1:
            rects.pop(k)
            return rects
    return rects


def close_section(pending_a: int, cur_frame: int) -> List[int]:
    """B press: [a, b] inclusive-exclusive, order-independent."""
    return [min(pending_a, cur_frame), max(pending_a, cur_frame) + 1]


def marker_percent(frame: int, total_frames: int) -> float:
    """Slider marker position as a percentage of the track."""
    return 0.0 if total_frames < 2 else 100.0 * frame / (total_frames - 1)


def resolve_theme(pref: str, system_dark: bool) -> str:
    """Effective theme from the persisted choice + the OS preference.

    Mirror of ``Selection.resolveTheme``. Reference:
    tools/theme_listener.py — the darkdetect callback maps the OS theme to
    ``Theme.DARK``/``Theme.LIGHT`` and applies it only while the configured
    mode is ``Theme.AUTO``; explicit light/dark choices win.
    """
    if pref in ("light", "dark"):
        return pref
    return "dark" if system_dark else "light"
