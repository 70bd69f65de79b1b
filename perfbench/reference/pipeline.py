"""Plain reference of the subtitle remover's STTN frame path, from the frames
and the mask the benchmark made to the frames a user gets back.

Written from the published tool (YaoFANGUK/video-subtitle-remover v1.4.0,
``backend/inpaint/sttn_auto_inpaint.py``, ``sttn_det_inpaint.py``,
``backend/tools/inpaint_tools.py``, ``backend/main.py``) and the semantics
the port documents for it, in NumPy and float32 torch:

* the band: a full-width band of the configuration's height centred on the
  mask (one connected mask region; the benchmark's masks are one);
* the model input: the band resized to the model's size, bilinear with
  half-pixel centres, edge clamp and round-half-up (sttn-auto), or with
  OpenCV's ``cv2.resize`` as the published sttn-det does, frames and mask;
* the windows: a window every ``neighbor_stride`` frames over its
  neighbours within the stride and every ``ref_length``-th frame besides,
  each run through the generator on exactly those frames;
* the composite: each window's neighbour predictions to uint8 (truncated),
  in sttn-det first merged with the source under the model-size hole mask,
  the first window's taken as is and each later one averaged 0.5 / 0.5 in
  float, truncated to uint8 at the end;
* the paste: the composite resized back to the band, bilinear as above, and
  written into the frame where the mask is set.

Every model input is BGR flipped to RGB in [-1, 1], every prediction flipped
back, as the tool does. Nothing here comes from the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Band = Tuple[int, int]  # (ymin, ymax), full width


# ---- image arithmetic (float32, on the device the frames are on) ----

def _axis(in_size: int, out_size: int, device):
    """Source indices and weight of a half-pixel-centred bilinear axis."""
    f32 = torch.float32
    scale = torch.tensor(in_size, dtype=f32) / torch.tensor(out_size, dtype=f32)
    src = (torch.arange(out_size, dtype=f32) + 0.5) * scale - 0.5
    i0 = torch.floor(src).long()
    w = src - i0.to(f32)
    i1 = i0 + 1
    neg = i0 < 0
    i0, i1, w = i0.masked_fill(neg, 0), i1.masked_fill(neg, 0), w.masked_fill(neg, 0.0)
    i1 = i1.clamp(max=in_size - 1)
    i0 = i0.clamp(max=in_size - 1)
    return i0.to(device), i1.to(device), w.to(device)


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int, rows=None) -> torch.Tensor:
    """uint8 [n, h, w, 3] -> uint8 [n, out_h, out_w, 3]; ``rows``: only
    those output rows."""
    y0, y1, wy = _axis(img.shape[1], out_h, img.device)
    x0, x1, wx = _axis(img.shape[2], out_w, img.device)
    if rows is not None:
        rows = torch.as_tensor(rows, device=img.device)
        y0, y1, wy = y0[rows], y1[rows], wy[rows]
    f = img.float()
    top, bottom = f[:, y0], f[:, y1]
    wy, wx = wy[None, :, None, None], wx[None, None, :, None]
    v = ((1 - wy) * (1 - wx) * top[:, :, x0] + (1 - wy) * wx * top[:, :, x1]
         + wy * (1 - wx) * bottom[:, :, x0] + wy * wx * bottom[:, :, x1])
    return torch.floor(v + 0.5).to(torch.uint8)


def _regions(mask: np.ndarray) -> int:
    """Number of 8-connected regions of a {0,1} mask, from its row runs."""
    parent: Dict[int, int] = {}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    prev: List[Tuple[int, int, int]] = []
    for row in mask.astype(bool):
        edges = np.flatnonzero(np.diff(np.concatenate([[0], row.view(np.int8), [0]])))
        runs = [(len(parent) + i, int(a), int(b)) for i, (a, b) in
                enumerate(zip(edges[::2], edges[1::2]))]
        for rid, a, b in runs:
            parent[rid] = rid
            for pid, pa, pb in prev:
                if pa <= b and a <= pb:  # overlapping or diagonal (runs are [a, b))
                    parent[find(pid)] = find(rid)
        prev = runs
    return len({find(r) for r in parent})


def band_of(mask: np.ndarray, band_h: int) -> Band:
    """The full-width band of height ``band_h`` over a mask of one connected
    region: centred on the region's mean row, clamped to the frame, moved
    to the region's top where centring would cut it."""
    H = mask.shape[0]
    rows = np.flatnonzero(mask.any(axis=1))
    if len(rows) == 0:
        raise ValueError("empty mask")
    if _regions(mask) != 1:
        raise ValueError("the reference takes masks of one connected region")
    top, bottom = int(rows[0]), int(rows[-1]) + 1
    ys, _ = np.nonzero(mask)
    centre = int(ys.mean())

    def clamp(ymin):
        ymin = max(0, ymin)
        ymax = ymin + band_h
        if ymax > H:
            ymax, ymin = H, max(0, H - band_h)
        return ymin, ymax

    ymin, ymax = clamp(centre - band_h // 2)
    if ymin > top or ymax < bottom:
        if bottom - top <= band_h:
            ymin, ymax = clamp(top)
        else:
            ymin, ymax = clamp((top + bottom) // 2 - band_h // 2)
    return ymin, ymax


# ---- the window schedule ----

def windows(t: int, stride: int, ref_length: int):
    """(neighbour ids, reference ids) of each window of a t-frame chunk."""
    for f in range(0, t, stride):
        nbrs = list(range(max(0, f - stride), min(t, f + stride + 1)))
        refs = [i for i in range(0, t, ref_length) if i not in nbrs]
        yield nbrs, refs


@torch.no_grad()
def inpaint_chunk(model, frames, holes, stride: int, ref_length: int, device) -> torch.Tensor:
    """Model-size BGR uint8 frames [t, h, w, 3] (and sttn-det's {0,1} holes
    [t, h, w]), arrays or tensors -> the composited BGR uint8 [t, h, w, 3]
    on ``device``."""
    frames = torch.as_tensor(frames).to(device)
    t = len(frames)
    x = frames.flip(-1).permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
    m = None
    if holes is not None:
        m = torch.as_tensor(holes).to(device).float()[:, None]
        x = x * (1.0 - m)
    feats = model.encode(x)
    src = frames.float()
    comp: List[Optional[torch.Tensor]] = [None] * t
    for nbrs, refs in windows(t, stride, ref_length):
        ids = nbrs + refs
        out = model.infer(feats[ids], None if m is None else m[ids])
        pred = model.decode(out[:len(nbrs)])
        img = ((pred + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
        img = img.permute(0, 2, 3, 1).flip(-1).float()  # RGB -> BGR
        for j, idx in enumerate(nbrs):
            if m is not None:
                hole = m[idx, 0, :, :, None]
                img_j = img[j] * hole + src[idx] * (1.0 - hole)
            else:
                img_j = img[j]
            comp[idx] = img_j if comp[idx] is None else comp[idx] * 0.5 + img_j * 0.5
    return torch.stack(comp).to(torch.uint8)


def paste(frames: torch.Tensor, comp: torch.Tensor, band: Band,
          mask01: np.ndarray) -> torch.Tensor:
    """A copy of ``frames`` [n, H, W, 3] with the band-size resize of
    ``comp`` [n, h, w, 3] written where ``mask01`` [H, W] is set."""
    ymin, ymax = band
    rows = np.flatnonzero(mask01[ymin:ymax].any(axis=1))
    up = bilinear_resize(comp, ymax - ymin, frames.shape[2], rows)
    out = frames.clone()
    at = torch.as_tensor(ymin + rows, device=frames.device)
    sel = torch.as_tensor(mask01[ymin + rows].astype(bool), device=frames.device)
    out[:, at] = torch.where(sel[None, :, :, None], up, out[:, at])
    return out


def sttn_auto(model, frames: Sequence[np.ndarray], mask: np.ndarray, cfg: dict,
              device) -> torch.Tensor:
    """One chunk of full-size BGR frames under a uint8 mask (0 / 255) ->
    the frames a user gets back, uint8 [n, H, W, 3] on ``device``."""
    mask01 = (mask > 127).astype(np.uint8)
    W = frames[0].shape[1]
    num, den = cfg["band_height_of_width"]
    band = band_of(mask01, W * num // den)
    mw, mh = cfg["input_size"]
    full = torch.from_numpy(np.stack(frames)).to(device)
    scaled = bilinear_resize(full[:, band[0]:band[1]], mh, mw)
    comp = inpaint_chunk(model, scaled, None, cfg["neighbor_stride"], cfg["ref_length"], device)
    return paste(full, comp, band, mask01)


def sttn_det(model, frames: Sequence[np.ndarray], mask: np.ndarray, cfg: dict,
             device) -> torch.Tensor:
    """One batch of full-size BGR frames under a uint8 mask (0 / 255), in
    chunks of at most ``chunk_frames`` -> uint8 [n, H, W, 3] on ``device``."""
    import cv2  # the published sttn-det's own resize

    mask01 = (mask > 0).astype(np.uint8)
    H, W = mask.shape
    num, den = cfg["band_height_of_height"] if H > W else cfg["band_height_of_width"]
    band = band_of(mask01, (H if H > W else W) * num // den)
    size = tuple(cfg["input_size"])
    scaled = np.stack([cv2.resize(f[band[0]:band[1]], size) for f in frames])
    holes = (cv2.resize(mask[band[0]:band[1]], size) > 0.5).astype(np.uint8)
    out = []
    step = cfg["chunk_frames"]
    for s in range(0, len(frames), step):
        part = scaled[s:s + step]
        comp = inpaint_chunk(model, part, np.repeat(holes[None], len(part), 0),
                             cfg["neighbor_stride"], cfg["ref_length"], device)
        full = torch.from_numpy(np.stack(frames[s:s + step])).to(device)
        out.append(paste(full, comp, band, mask01))
    return torch.cat(out)


# ---- the detection-driven schedule (backend/main.py, inpaint_tools.py) ----

def ranges_with_same_boxes(boxes: Dict[int, list]) -> List[Tuple[int, int]]:
    """Maximal runs of consecutive frame numbers with equal box lists."""
    out: List[Tuple[int, int]] = []
    for f in sorted(boxes):
        if out and f == out[-1][1] + 1 and boxes[f] == boxes[out[-1][1]]:
            out[-1] = (out[-1][0], f)
        else:
            out.append((f, f))
    return out


def expand(ranges: List[Tuple[int, int]], back: int, fwd: int) -> List[Tuple[int, int]]:
    """Grow each range by ``back`` / ``fwd`` frames without overlapping its
    neighbours (inpaint_tools.expand_frame_ranges)."""
    out: List[Tuple[int, int]] = []
    for i, (s, e) in enumerate(ranges):
        ns, ne = max(1, s - back), e + fwd
        if i + 1 < len(ranges) and ne >= ranges[i + 1][0]:
            nxt = ranges[i + 1][0]
            ne = e if nxt - e == 1 else min(ne, nxt - 1)
        if out and ns <= out[-1][1]:
            ns = out[-1][1] + 1
        out.append((ns, ne) if ns <= ne else (s, e))
    return out


def merge_short(ranges: List[Tuple[int, int]], target: int) -> List[Tuple[int, int]]:
    """Widen single frames by (target - 1) // 2 each way within their
    neighbours, then merge touching ranges while either is shorter than
    ``target`` (subtitle_detect.filter_and_merge_intervals)."""
    if not ranges:
        return []
    half = (target - 1) // 2
    wide: List[Tuple[int, int]] = []
    for i, (s, e) in enumerate(ranges):
        if s == e:
            lo = max(s - half, wide[-1][1] + 1 if wide else s - half)
            hi = min(s + half, ranges[i + 1][0] - 1 if i + 1 < len(ranges) else s + half)
            wide.append((lo, hi) if lo <= hi else (s, s))
        else:
            wide.append((s, e))
    merged = [wide[0]]
    for s, e in wide[1:]:
        ls, le = merged[-1]
        if s <= le + 1 and (e - s + 1 < target or le - ls + 1 < target):
            merged[-1] = (ls, max(le, e))
        else:
            merged.append((s, e))
    return merged


def batches(n: int, max_batch: int) -> List[Tuple[int, int]]:
    """(start, stop) of near-uniform batches of at most ``max_batch`` of n
    items: the size is lowered until the remainder is at least half a batch
    (inpaint_tools.batch_generator)."""
    size = max(1, max_batch)
    while size > 1 and n % size < size / 2.0:
        size -= 1
    out = [(i * size, (i + 1) * size) for i in range(n // size)]
    if (n // size) * size < n:
        out.append(((n // size) * size, n))
    return out


def rasterize(shape: Tuple[int, int], boxes, dilation: int) -> np.ndarray:
    """uint8 mask (0 / 255) of (xmin, xmax, ymin, ymax) boxes grown by
    ``dilation`` px, corners inclusive (cv2.rectangle)."""
    h, w = shape
    mask = np.zeros((h, w), np.uint8)
    for xmin, xmax, ymin, ymax in boxes:
        x1, y1 = max(0, xmin - dilation), max(0, ymin - dilation)
        x2, y2 = xmax + dilation, ymax + dilation
        if x2 < 0 or y2 < 0 or x1 >= w or y1 >= h:
            continue
        mask[y1:min(y2 + 1, h), x1:min(x2 + 1, w)] = 255
    return mask


def det_schedule(boxes: Dict[int, list], n_frames: int, cfg: dict):
    """Batches of the detection-driven loop over frames 1..n_frames:
    [(first frame number, last frame number, box list)] in order."""
    ranges = expand(ranges_with_same_boxes(boxes), cfg["timeline_backward_frames"],
                    cfg["timeline_forward_frames"])
    ranges = merge_short(ranges, cfg["ref_length"])
    out = []
    for s, e in ranges:
        e = min(e, n_frames)
        if s > n_frames:
            break
        coords: list = []
        for f in range(s, e):  # the range's last frame is left out, as upstream does
            for box in boxes.get(f, ()):
                xmin, xmax, ymin, ymax = box
                if (ymax - ymin) - (xmax - xmin) > cfg["yx_axis_difference"]:
                    continue
                if tuple(box) not in coords:
                    coords.append(tuple(box))
        for b0, b1 in batches(e - s + 1, cfg["chunk_frames"]):
            out.append((s + b0, s + b1 - 1, coords))
    return out
