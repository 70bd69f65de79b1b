"""Selection-canvas geometry unit vectors for the port's GUI.

Every case of tests/test_gui_selection.py against the port's copy,
vsr_tpu_torch/gui/selection_model.py (the python mirror of
gui/selection.js), plus both packages' selection models giving equal
results on every input of the committed selection_vectors.json.

Drives vsr_tpu_torch/gui/selection_model.py — the python mirror of
gui/selection.js — through explicit scenarios (coordinate transforms under
CSS + preview downscaling, drag-new/move/resize state machine, border
clamps, corner normalization, degenerate-rect discard, AB sections), and
snapshots every case to gui/selection_vectors.json so a JS runner can pin
selection.js to the identical behavior. A regex consistency check keeps the
two files' constants and the index.html wiring from drifting.

Reference behavior: ui/component/video_display_component.py:686-812.
"""

import json
import os
import re

import pytest

from vsr_tpu.gui import selection_model as jax_sm
from vsr_tpu_torch.gui import selection_model as sm

GUI_DIR = os.path.join(os.path.dirname(__file__), "..", "vsr_tpu_torch", "gui")
VECTORS_PATH = os.path.join(GUI_DIR, "selection_vectors.json")

VECTORS = []


def record(name, fn, inputs, out):
    VECTORS.append({"case": name, "fn": fn, "inputs": inputs, "out": out})
    return out


class TestCoordinateTransforms:
    def test_canvas_pos_css_scaling(self):
        # canvas bitmap 640x360 rendered in a 320x180 CSS box at (100, 50):
        # a client click at its center maps to the bitmap center
        bounds = {"left": 100.0, "top": 50.0, "width": 320.0, "height": 180.0}
        out = sm.canvas_pos(260.0, 140.0, bounds, 640, 360)
        assert out == (320.0, 180.0)
        record("canvas_pos_css_scaling", "canvasPos",
               [260.0, 140.0, bounds, 640, 360], list(out))

    def test_scale_xy_downscaled_preview(self):
        # 1920x1080 video served as a 640x360 preview jpeg -> scale 3x
        out = sm.scale_xy((1920, 1080), 640, 360)
        assert out == (3.0, 3.0)
        record("scale_xy_downscaled_preview", "scaleXY",
               [[1920, 1080], 640, 360], list(out))

    def test_full_chain_video_coords(self):
        # click at client (420, 230) in the box above over the 3x preview
        bounds = {"left": 100.0, "top": 50.0, "width": 320.0, "height": 180.0}
        cx, cy = sm.canvas_pos(420.0, 230.0, bounds, 640, 360)
        sx, sy = sm.scale_xy((1920, 1080), 640, 360)
        assert (cx * sx, cy * sy) == (1920.0, 1080.0)  # bottom-right corner


class TestDragStateMachine:
    def test_new_rect_drag(self):
        rects, drag = sm.begin_drag([], 100.0, 200.0, 1.0, 1.0)
        assert rects == [[200.0, 200.0, 100.0, 100.0]]
        assert drag == {"k": 0, "mode": "resize"}
        record("new_rect_mousedown", "beginDrag", [[], 100.0, 200.0, 1.0, 1.0],
               {"rects": rects, "drag": drag})
        rects = sm.apply_drag(rects, drag, 180.0, 260.0, (1920, 1080))
        assert rects == [[200.0, 260, 100.0, 180]]
        rects = sm.end_drag(rects, drag)
        assert rects == [[200.0, 260, 100.0, 180]]

    def test_resize_handle_beats_body(self):
        rects = [[100, 200, 100, 300]]
        _, drag = sm.begin_drag(rects, 295.0, 195.0, 1.0, 1.0)
        assert drag == {"k": 0, "mode": "resize"}  # within 12px of (300,200)
        record("resize_handle_beats_body", "beginDrag",
               [rects, 295.0, 195.0, 1.0, 1.0], {"drag": drag})

    def test_handle_radius_scales_with_preview(self):
        # 3x-downscaled preview: 12 canvas px = 36 video px
        rects = [[100, 200, 100, 300]]
        out, drag = sm.begin_drag(rects, 330.0, 230.0, 3.0, 3.0)
        assert drag == {"k": 0, "mode": "resize"} and len(out) == 1
        # same video point at 1x: outside the 12px handle -> a NEW rect
        out, drag = sm.begin_drag(rects, 330.0, 230.0, 1.0, 1.0)
        assert drag == {"k": 1, "mode": "resize"} and len(out) == 2
        record("handle_radius_scales", "beginDrag",
               [rects, 330.0, 230.0, 3.0, 3.0],
               {"drag": {"k": 0, "mode": "resize"}})

    def test_topmost_rect_wins(self):
        rects = [[0, 400, 0, 400], [100, 300, 100, 300]]
        _, drag = sm.begin_drag(rects, 200.0, 200.0, 1.0, 1.0)
        assert drag["k"] == 1 and drag["mode"] == "move"
        record("topmost_rect_wins", "beginDrag",
               [rects, 200.0, 200.0, 1.0, 1.0], {"drag": drag})

    def test_move_clamps_at_borders(self):
        rects = [[100, 200, 100, 300]]
        _, drag = sm.begin_drag(rects, 150.0, 150.0, 1.0, 1.0)
        assert drag["mode"] == "move"
        out = sm.apply_drag(rects, drag, -500.0, -500.0, (1920, 1080))
        assert out == [[0, 100, 0, 200]]
        record("move_clamps_top_left", "applyDrag",
               [rects, drag, -500.0, -500.0, [1920, 1080]], out)
        out = sm.apply_drag(rects, drag, 5000.0, 5000.0, (1920, 1080))
        assert out == [[980, 1080, 1720, 1920]]
        record("move_clamps_bottom_right", "applyDrag",
               [rects, drag, 5000.0, 5000.0, [1920, 1080]], out)

    def test_resize_pointer_clamps_to_video(self):
        rects = [[100, 200, 100, 300]]
        drag = {"k": 0, "mode": "resize"}
        out = sm.apply_drag(rects, drag, 99999.0, 99999.0, (1920, 1080))
        assert out == [[100, 1080, 100, 1920]]
        record("resize_pointer_clamps", "applyDrag",
               [rects, drag, 99999.0, 99999.0, [1920, 1080]], out)

    def test_inverted_resize_normalizes_on_release(self):
        # dragging up-left past the anchor: corners swap on mouseup
        rects, drag = sm.begin_drag([], 300.0, 300.0, 1.0, 1.0)
        rects = sm.apply_drag(rects, drag, 100.0, 150.0, (1920, 1080))
        assert rects == [[300.0, 150, 300.0, 100]]
        out = sm.end_drag(rects, drag)
        assert out == [[150, 300.0, 100, 300.0]]
        record("inverted_resize_normalizes", "endDrag", [rects, drag], out)

    def test_degenerate_rect_discarded_on_release(self):
        rects, drag = sm.begin_drag([], 100.0, 100.0, 1.0, 1.0)
        rects = sm.apply_drag(rects, drag, 102.0, 140.0, (1920, 1080))
        out = sm.end_drag(rects, drag)  # 2px wide < MIN_SIZE
        assert out == []
        record("degenerate_rect_discarded", "endDrag", [rects, drag], out)

    def test_dblclick_removes_topmost_only(self):
        rects = [[0, 400, 0, 400], [100, 300, 100, 300]]
        out = sm.remove_at(rects, 200.0, 200.0)
        assert out == [[0, 400, 0, 400]]
        record("dblclick_removes_topmost", "removeAt",
               [rects, 200.0, 200.0], out)
        out = sm.remove_at(out, 2000.0, 2000.0)  # miss: no-op
        assert out == [[0, 400, 0, 400]]

    def test_js_round_half_up(self):
        # Math.round(0.5) == 1 (NOT python's banker's round(0.5) == 0)
        assert sm._js_round(0.5) == 1
        assert sm._js_round(1.5) == 2
        assert sm._js_round(2.5) == 3
        assert sm._js_round(2.4) == 2


class TestABSections:
    def test_close_section_order_independent(self):
        assert sm.close_section(10, 50) == [10, 51]
        assert sm.close_section(50, 10) == [10, 51]
        record("close_section_fwd", "closeSection", [10, 50], [10, 51])
        record("close_section_rev", "closeSection", [50, 10], [10, 51])

    def test_marker_percent(self):
        assert sm.marker_percent(0, 101) == 0.0
        assert sm.marker_percent(100, 101) == 100.0
        assert sm.marker_percent(5, 1) == 0.0  # degenerate track
        record("marker_percent", "markerPercent", [100, 101], 100.0)


class TestThemeResolution:
    """Reference tools/theme_listener.py: the OS theme drives the palette
    only in auto mode; explicit light/dark wins."""

    def test_auto_follows_system(self):
        assert sm.resolve_theme("auto", True) == "dark"
        assert sm.resolve_theme("auto", False) == "light"
        record("theme_auto_system_dark", "resolveTheme", ["auto", True],
               "dark")
        record("theme_auto_system_light", "resolveTheme", ["auto", False],
               "light")

    def test_explicit_choice_wins(self):
        assert sm.resolve_theme("light", True) == "light"
        assert sm.resolve_theme("dark", False) == "dark"
        record("theme_explicit_light_wins", "resolveTheme", ["light", True],
               "light")
        record("theme_explicit_dark_wins", "resolveTheme", ["dark", False],
               "dark")

    def test_unknown_pref_falls_back_to_auto(self):
        # corrupt localStorage value behaves like auto
        assert sm.resolve_theme("blurple", True) == "dark"
        record("theme_unknown_pref_auto", "resolveTheme", ["blurple", True],
               "dark")


class TestCrossLanguageContract:
    def test_vectors_snapshot_committed(self):
        """The committed vectors file matches this run (regenerate with
        VSR_UPDATE_VECTORS=1 after intentional behavior changes)."""
        if not VECTORS:
            pytest.skip("vector-producing tests did not run in this session")
        payload = json.dumps(
            sorted(VECTORS, key=lambda v: v["case"]), indent=1,
            sort_keys=True, default=list)
        if os.environ.get("VSR_UPDATE_VECTORS") or not os.path.exists(
                VECTORS_PATH):
            with open(VECTORS_PATH, "w") as f:
                f.write(payload + "\n")
        with open(VECTORS_PATH) as f:
            assert json.loads(f.read()) == json.loads(payload)

    def test_js_constants_match_python(self):
        with open(os.path.join(GUI_DIR, "selection.js")) as f:
            js = f.read()
        assert int(re.search(r"HANDLE:\s*(\d+)", js).group(1)) == sm.HANDLE
        assert int(re.search(r"MIN_SIZE:\s*(\d+)", js).group(1)) == sm.MIN_SIZE
        # every python api has a JS counterpart defined in the module
        for name in ["canvasPos", "scaleXY", "beginDrag", "applyDrag",
                     "endDrag", "removeAt", "closeSection", "markerPercent",
                     "resolveTheme"]:
            assert re.search(rf"\b{name}\(", js), name

    def test_index_html_uses_the_module(self):
        with open(os.path.join(GUI_DIR, "index.html")) as f:
            html = f.read()
        assert '<script src="/selection.js">' in html
        for call in ["Selection.beginDrag", "Selection.applyDrag",
                     "Selection.endDrag", "Selection.removeAt",
                     "Selection.closeSection", "Selection.markerPercent",
                     "Selection.canvasPos", "Selection.scaleXY",
                     "Selection.resolveTheme"]:
            assert call in html, call
        # no leftover inline geometry (the old hand-rolled hit test)
        assert "Math.abs(vx-x1)" not in html

    def test_index_html_theme_wiring(self):
        """Theme system (reference tools/theme_listener.py analog): both
        palettes defined, live OS-change listener, persisted pref."""
        with open(os.path.join(GUI_DIR, "index.html")) as f:
            html = f.read()
        assert 'html[data-theme="light"]' in html
        assert "prefers-color-scheme" in html
        assert 'addEventListener("change", applyTheme)' in html
        assert 'localStorage.getItem("vsr_theme")' in html
        # themed surfaces use variables, not literals frozen to dark
        for var in ["--btn", "--input", "--well"]:
            assert html.count(var) >= 3, var  # defined twice + >=1 use


# JS name in selection_vectors.json -> the python function of both models
_FNS = {"canvasPos": "canvas_pos", "scaleXY": "scale_xy", "beginDrag": "begin_drag",
        "applyDrag": "apply_drag", "endDrag": "end_drag", "removeAt": "remove_at",
        "closeSection": "close_section", "markerPercent": "marker_percent",
        "resolveTheme": "resolve_theme"}


def _committed_vectors():
    with open(VECTORS_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("vector", _committed_vectors(), ids=lambda v: v["case"])
def test_both_packages_agree_on_committed_vectors(vector):
    """The port's model and vsr_tpu's give equal results on each committed
    vector's inputs, and the port's equals what the vector recorded."""
    name = _FNS[vector["fn"]]
    got = getattr(sm, name)(*vector["inputs"])
    assert got == getattr(jax_sm, name)(*vector["inputs"])
    out = vector["out"]
    if isinstance(out, dict):  # beginDrag records {"drag"} and sometimes {"rects"}
        rects, drag = got
        assert drag == out["drag"]
        assert "rects" not in out or rects == out["rects"]
    else:
        assert json.loads(json.dumps(got)) == out

