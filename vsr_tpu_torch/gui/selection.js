// Selection-canvas geometry: pure functions, no DOM.
//
// The subtitle-area rect state machine and the canvas<->video coordinate
// transforms (reference: ui/component/video_display_component.py:686-812 —
// drag-new / move / resize with border clamps, plus AB section markers).
// Kept DOM-free so the logic is testable: vsr_tpu_torch/gui/selection_model.py is
// the line-for-line Python mirror, pytest drives both through the shared
// vectors in tests/test_gui_selection.py (committed JSON snapshot at
// gui/selection_vectors.json; a node/JS runner can consume the same file).
//
// Rects are [y0, y1, x0, x1] in VIDEO pixel coordinates. `info` is
// {width, height} of the video. A drag is {k, mode, ox, oy, w, h}.

const Selection = {
  HANDLE: 12,   // resize-handle hit radius, canvas px (scaled to video px)
  MIN_SIZE: 4,  // rects thinner than this on release are discarded

  // client event -> canvas bitmap coords (CSS scaling of the element)
  canvasPos(clientX, clientY, bounds, canvasW, canvasH) {
    return [(clientX - bounds.left) * canvasW / bounds.width,
            (clientY - bounds.top) * canvasH / bounds.height];
  },

  // canvas bitmap -> video coords scale (preview jpeg may be downscaled)
  scaleXY(info, canvasW, canvasH) {
    return [info.width / canvasW, info.height / canvasH];
  },

  // mousedown: returns {rects, drag} — resize-handle hit beats body hit,
  // topmost (last-drawn) rect wins, otherwise start a new rect
  beginDrag(rects, vx, vy, sx, sy) {
    rects = rects.map(r => r.slice());
    for (let k = rects.length - 1; k >= 0; k--) {
      const [y0, y1, x0, x1] = rects[k];
      if (Math.abs(vx - x1) < Selection.HANDLE * sx &&
          Math.abs(vy - y1) < Selection.HANDLE * sy)
        return {rects, drag: {k, mode: "resize"}};
      if (vx >= x0 && vx <= x1 && vy >= y0 && vy <= y1)
        return {rects, drag: {k, mode: "move", ox: vx - x0, oy: vy - y0,
                              w: x1 - x0, h: y1 - y0}};
    }
    rects.push([vy, vy, vx, vx]);
    return {rects, drag: {k: rects.length - 1, mode: "resize"}};
  },

  // mousemove: returns new rects; pointer clamps to the video bounds,
  // moves clamp the whole rect inside
  applyDrag(rects, drag, vx, vy, info) {
    rects = rects.map(r => r.slice());
    vx = Math.max(0, Math.min(info.width, vx));
    vy = Math.max(0, Math.min(info.height, vy));
    const r = rects[drag.k];
    if (drag.mode === "resize") {
      r[1] = Math.round(vy); r[3] = Math.round(vx);
    } else {
      const x0 = Math.max(0, Math.min(info.width - drag.w, vx - drag.ox));
      const y0 = Math.max(0, Math.min(info.height - drag.h, vy - drag.oy));
      rects[drag.k] = [Math.round(y0), Math.round(y0 + drag.h),
                       Math.round(x0), Math.round(x0 + drag.w)];
    }
    return rects;
  },

  // mouseup: normalize corners; degenerate rects are dropped
  endDrag(rects, drag) {
    rects = rects.map(r => r.slice());
    const r = rects[drag.k];
    rects[drag.k] = [Math.min(r[0], r[1]), Math.max(r[0], r[1]),
                     Math.min(r[2], r[3]), Math.max(r[2], r[3])];
    if (rects[drag.k][1] - rects[drag.k][0] < Selection.MIN_SIZE ||
        rects[drag.k][3] - rects[drag.k][2] < Selection.MIN_SIZE)
      rects.splice(drag.k, 1);
    return rects;
  },

  // dblclick: remove the topmost rect containing the point
  removeAt(rects, vx, vy) {
    rects = rects.map(r => r.slice());
    for (let k = rects.length - 1; k >= 0; k--) {
      const [y0, y1, x0, x1] = rects[k];
      if (vx >= x0 && vx <= x1 && vy >= y0 && vy <= y1) {
        rects.splice(k, 1);
        return rects;
      }
    }
    return rects;
  },

  // B press: close the pending section; [a, b] inclusive-exclusive,
  // order-independent
  closeSection(pendingA, curFrame) {
    return [Math.min(pendingA, curFrame), Math.max(pendingA, curFrame) + 1];
  },

  // slider marker position as a percentage of the track
  markerPercent(frame, totalFrames) {
    return totalFrames < 2 ? 0 : 100 * frame / (totalFrames - 1);
  },

  // theme resolution (reference: tools/theme_listener.py — darkdetect
  // callback -> setTheme, with Theme.AUTO following the OS). pref is the
  // persisted user choice "auto" | "light" | "dark"; systemDark is the
  // OS preference (prefers-color-scheme). Returns the effective theme.
  resolveTheme(pref, systemDark) {
    if (pref === "light" || pref === "dark") return pref;
    return systemDark ? "dark" : "light";
  },
};

if (typeof module !== "undefined") module.exports = Selection;  // node tests
