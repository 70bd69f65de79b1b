"""ProPainter inpainting mode (PyTorch): counterpart of
``vsr_tpu/inpaint/propainter.py`` (the reference's
backend/inpaint/propainter_inpaint.py:137-418).

One clip runs in four stages on the device:

1. RAFT bidirectional flows in fp32 whatever ``compute_dtype`` says: every
   frame is encoded once, then the pairs run in chunks sized by the free
   device memory (each pair's fp32 correlation pyramid holds
   ~1.34 (H/8 * W/8)^2 * 4 bytes), both directions of a chunk in one call;
2. recurrent flow completion in ``propainter_subvideo_length`` chunks with a
   5-frame halo (ref :253-281);
3. parameter-free image propagation in chunks of at most 100 frames with a
   10-frame halo (ref :283-316);
4. the reference's ragged window sweep: windows every
   ``propainter_neighbor_length // 2`` frames with global references every
   ``propainter_ref_stride`` (ref :320-358). The clip's frames are encoded
   once and each window gathers its rows; for a mask that is the same in
   every frame (every clip here) the attention's masked branch runs only
   for the windows that hold mask. Each window's prediction is composited
   on the device with the reference's uint8 0.5/0.5 overlap blend, in
   window order.

With a ``mesh`` (``parallel.mesh``), the window sweep runs its windows in
groups of one window per device: a window's prediction depends only on the
clip's encoding, the completed flows and the masks, never on the composite,
so each device's generator replica predicts one window of the group from
inputs gathered on the first device, and the predictions come back to be
composited there in window order, as without a mesh. Stages 1-3 and the
encoding run on the first device.

Masks are dilated with scipy's binary_dilation, 4 iterations, for both the
flow and the frame masks (ref read_mask). The host sends the clip's uint8
BGR frames once and receives only the rows that hold the dilated mask:
elsewhere the composite is the source (prediction * mask + source * (1 -
mask), and the blend of two equal uint8 values is that value). ``__call__``
crops native-resolution full-width bands rounded to multiples of 8;
``inpaint()`` runs the whole frame as one band, and ``outpaint()`` the
whole canvas with its own flow mask.

All three run one host path, persistent and batched, band by band from a
band's plan (box, flow and frame masks on the device, rows, masked
windows). ``__call__`` makes a mask's plans on its first clip and keeps
them (``MASKS_KEPT`` masks, by their bytes). Each band's crops go into one
persistent host buffer (pinned on a card) in one native call on the host
pool and reach the device by one asynchronous H2D; the returned rows come
back by one D2H into a second persistent buffer; one native call then
writes each output frame once (rows outside the returned ones from the
input frame). The buffers grow to the largest clip seen and are re-made
only then.

Spans (``utils.tracing``, recorded only while a torch profiler records):
``vsr.pp.clip`` around each clip (frames, band pixels), over
``vsr.pp.prepare`` (the band plans; per band the crop, the H2D, with the
pool workers that cropped and ``staged`` 1 where both buffers were reused),
the four device stages ``vsr.pp.flows`` (pairs, pair chunks),
``vsr.pp.complete`` (sub-videos), ``vsr.pp.propagate`` and
``vsr.pp.sweep`` (encode and windows: windows, attention windows,
attention windows whose masked branch ran), each carrying its device time
on a card, and ``vsr.pp.finish`` (the D2H and the compose, with the pool
workers that composed).

The JAX package's default pads every window to one static shape to bound
XLA compiles; this port keeps the reference's ragged windows (the JAX
package's VSR_PP_DYNAMIC_WINDOWS=1 path), so it has neither the padding nor
the frame-validity masks that made boundary windows differ.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.ndimage
import torch

from vsr_tpu_torch import native
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint.weights import (
    load_flow_completion_weights,
    load_propainter_weights,
    load_raft_weights,
)
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet
from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator, image_propagation
from vsr_tpu_torch.models.propainter.raft import ENCODE_CHUNK, RAFT, raft_bi_flows
from vsr_tpu_torch.parallel.mesh import replicate
from vsr_tpu_torch.utils import tracing
from vsr_tpu_torch.utils.device import items_per_chunk, resolve_device


def get_ref_index(mid, neighbor_ids, length, ref_stride=10, ref_num=-1):
    """Global reference frame selection (ref :120-134)."""
    ref_index = []
    if ref_num == -1:
        for i in range(0, length, ref_stride):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start_idx = max(0, mid - ref_stride * (ref_num // 2))
        end_idx = min(length, mid + ref_stride * (ref_num // 2))
        for i in range(start_idx, end_idx, ref_stride):
            if i not in neighbor_ids:
                if len(ref_index) > ref_num:
                    break
                ref_index.append(i)
    return ref_index


def dilate_mask(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Binary dilation (scipy's default 4-connectivity, ref read_mask)."""
    binary = np.asarray(mask).squeeze() > 0
    if iterations > 0:
        binary = scipy.ndimage.binary_dilation(binary, iterations=iterations)
    return binary.astype(np.float32)


def short_clip_len_for_width(width: int) -> int:
    """The reference's RAFT pair-chunk table (propainter_inpaint.py:221-228),
    keyed by width for full frames on ~24 GB cards. The port sizes its
    chunks by free device memory instead."""
    if width <= 640:
        return 12
    if width <= 720:
        return 8
    if width <= 1280:
        return 4
    return 2


def raft_pair_bytes(height: int, width: int) -> float:
    """Bytes of one pair's fp32 correlation pyramid (the levels sum to
    ~1.34 times the first)."""
    n = max(1, (height // 8) * (width // 8))
    return n * n * 4 * 1.34


# the masks whose band plans an inpainter keeps (a run of frames under one
# box set reuses its mask for every clip)
MASKS_KEPT = 4


class _Band(NamedTuple):
    """One band of a clip's frames, as every clip under its masks needs it."""
    box: Tuple[int, int, int, int]       # ymin, ymax, xmin, xmax in the frame
    rows: Optional[Tuple[int, int]]      # the frame mask's rows in the band
    flow_mask: torch.Tensor              # [h, w] float32, on the device
    hole: torch.Tensor                   # [h, w] float32 frame mask, on the device
    masked_windows: Optional[torch.Tensor]  # _masked_window_set, on the device


def _halo_chunks(length: int, sub: int, pad: int):
    """(start, end, keep_from, keep_to) of chunks of ``sub`` items with
    ``pad`` items of halo on each side, clipped to [0, length)."""
    for f in range(0, length, sub):
        s, e = max(0, f - pad), min(length, f + sub + pad)
        yield s, e, f - s, (e - s) - (e - min(length, f + sub))


class PropainterInpainter:
    """Uniform inpainter contract: __call__(frames, mask) -> frames."""

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        config: Optional[Config] = None,
        generator_kwargs: Optional[dict] = None,
        raft_kwargs: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self.config = config or Config()
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32
        self.sub_video_length = self.config.propainter_subvideo_length
        self.neighbor_stride = self.config.propainter_neighbor_length // 2
        self.ref_stride = self.config.propainter_ref_stride
        self.mask_dilation = 4

        def ckpt(name):
            return os.path.join(checkpoint_dir, name) if checkpoint_dir else None

        raft = RAFT(iters=self.config.propainter_raft_iters, **(raft_kwargs or {}))
        load_raft_weights(raft, ckpt("raft.npz"))
        flow_net = RecurrentFlowCompleteNet()
        load_flow_completion_weights(flow_net, ckpt("flow_completion.npz"))
        generator = ProPainterGenerator(**(generator_kwargs or {}))
        load_propainter_weights(generator, ckpt("propainter.npz"))
        self.raft = raft.to(self.device, torch.float32).eval()
        self.flow_net = flow_net.to(self.device, dtype).eval()
        self.generator = generator.to(self.device, dtype).eval()
        # the window sweep's generators, one per mesh device (None: the
        # generator alone)
        self.replicas = replicate(self.generator, mesh) if mesh else None
        # __call__'s band plans by mask, and the persistent host staging
        # (pinned on a card): a band's crops in, its returned rows out
        self._plans: Dict[tuple, List[_Band]] = {}
        self._host_in: Optional[torch.Tensor] = None
        self._host_out: Optional[torch.Tensor] = None
        self._h2d_done: Optional[torch.cuda.Event] = None

    # ---- stages ----
    def _compute_flows(self, frames_n: torch.Tensor,
                       span=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames_n [T, 3, H, W] in [-1, 1] -> (flows_f, flows_b), each
        [T-1, 2, H, W]: flow i is frame i -> i+1, and i+1 -> i. ``span``:
        a tracing span that counts the pairs and their chunks."""
        T, _, H, W = frames_n.shape
        # both directions of a chunk go in one call: 2 pyramids a pair, in at
        # most 40% of the free memory (the rest for the encodings, the
        # lookups, the update block and the allocator's fragments)
        chunk = items_per_chunk(self.device, T - 1, 2 * raft_pair_bytes(H, W), fraction=0.4)
        if span is not None:
            span.add(pairs=T - 1, pair_chunks=len(range(0, T - 1, chunk)))
        flows_f, flows_b = raft_bi_flows(self.raft, frames_n[None], pair_chunk=chunk)
        return flows_f[0], flows_b[0]

    def _flow_complete(self, flows_f, flows_b, masks):
        bi = (flows_f[None], flows_b[None])
        pred = self.flow_net.forward_bidirect_flow(bi, masks[None])
        out_f, out_b = RecurrentFlowCompleteNet.combine_flow(bi, pred, masks[None])
        return out_f[0], out_b[0]

    def _complete_flows(self, flows_f, flows_b, flow_masks):
        """Chunked flow completion with a 5-frame halo (ref :253-281)."""
        n = len(flows_f)
        if n <= self.sub_video_length:
            return self._flow_complete(flows_f, flows_b, flow_masks)
        pf, pb = [], []
        for s, e, keep0, keep1 in _halo_chunks(n, self.sub_video_length, 5):
            of, ob = self._flow_complete(flows_f[s:e], flows_b[s:e], flow_masks[s:e + 1])
            pf.append(of[keep0:keep1])
            pb.append(ob[keep0:keep1])
        return torch.cat(pf), torch.cat(pb)

    def _propagate_images(self, frames_n, masks, flows_f, flows_b):
        """Chunked image propagation with a 10-frame halo (ref :283-316):
        (frames with the propagated pixels pasted into the holes, the holes
        still left)."""
        T = len(frames_n)
        masked = frames_n * (1 - masks)
        sub = min(100, self.sub_video_length)
        frames_out, masks_out = [], []
        for s, e, keep0, keep1 in _halo_chunks(T, sub, 10):
            prop, upd = image_propagation(masked[None, s:e], masks[None, s:e],
                                          flows_f[None, s:e - 1], flows_b[None, s:e - 1])
            updated = frames_n[s:e] * (1 - masks[s:e]) + prop[0] * masks[s:e]
            frames_out.append(updated[keep0:keep1])
            masks_out.append(upd[0][keep0:keep1])
        return torch.cat(frames_out), torch.cat(masks_out)

    def _encode_clip(self, frames, masks, updated_masks) -> torch.Tensor:
        """The generator's per-frame encoding of the whole clip, [1, T, C, h, w]."""
        T = len(frames)
        return torch.cat([self.generator.encode(frames[None, s:s + ENCODE_CHUNK],
                                                masks[None, s:s + ENCODE_CHUNK],
                                                updated_masks[None, s:s + ENCODE_CHUNK])
                          for s in range(0, T, ENCODE_CHUNK)], dim=1)

    def _windows(self, T: int):
        """The reference's ragged windows: (neighbor ids, reference ids)."""
        ref_num = self.sub_video_length // self.ref_stride if T > self.sub_video_length else -1
        windows = []
        for f in range(0, T, self.neighbor_stride):
            ns = list(range(max(0, f - self.neighbor_stride), min(T, f + self.neighbor_stride + 1)))
            windows.append((ns, get_ref_index(f, ns, T, self.ref_stride, ref_num)))
        return windows

    def _sweep_windows(self, enc_all, comp_f, comp_b, masks, updated_masks, rgb, hole,
                       rows: Tuple[int, int], masked_windows) -> torch.Tensor:
        """Every window through the generator, composited into the rows
        [r0, r1) of each neighbour frame in window order: where the hole is,
        the prediction (first write) or the uint8 0.5/0.5 blend with the
        earlier composite; elsewhere the source. -> [T, 3, r1 - r0, W]
        uint8 RGB."""
        r0, r1 = rows
        T = len(rgb)
        src = rgb[:, :, r0:r1]
        bmask = hole[:, r0:r1].to(torch.uint8)  # [1, r1 - r0, W]
        comp = torch.empty_like(src)
        written = [False] * T
        windows = self._windows(T)
        replicas = self.replicas or [self.generator]
        devices = [next(g.parameters()).device for g in replicas]
        mw = {dev: None if masked_windows is None else masked_windows.to(dev) for dev in devices}
        for g0 in range(0, len(windows), len(replicas)):
            group = windows[g0:g0 + len(replicas)]
            # every window's inputs leave the first device before any window
            # is computed, so no copy waits behind the first device's window
            inputs = [self._window_inputs(dev, enc_all, comp_f, comp_b, masks, updated_masks,
                                          ns, rs) for dev, (ns, rs) in zip(devices, group)]
            preds = [gen.forward_encoded(*x, len(ns), masked_windows=mw[dev])[0]
                     for gen, dev, x, (ns, _) in zip(replicas, devices, inputs, group)]
            for (ns, _), pred in zip(group, preds):
                pred_u8 = ((pred[:, :, r0:r1] + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
                pred_u8 = pred_u8.to(self.device, non_blocking=True)
                ids = torch.tensor(ns, device=self.device)
                img = pred_u8 * bmask + src[ids] * (1 - bmask)
                again = torch.tensor([written[i] for i in ns], device=self.device)
                blended = (comp[ids].float() * 0.5 + img.float() * 0.5).to(torch.uint8)
                comp[ids] = torch.where(again[:, None, None, None], blended, img)
                for i in ns:
                    written[i] = True
        return comp

    def _window_inputs(self, dev, enc_all, comp_f, comp_b, masks, updated_masks, ns, rs):
        """One window's rows of the clip's encoding, completed flows and
        masks, gathered on the first device and sent to ``dev``: the
        generator's forward_encoded arguments before the neighbour count."""
        sel = torch.tensor(ns + rs, device=self.device)
        pair = torch.tensor(ns[:-1], device=self.device)

        def to(t):
            return t.to(dev, non_blocking=True)

        return (to(enc_all[:, sel]), (to(comp_f[None, pair]), to(comp_b[None, pair])),
                to(masks[None, sel]), to(updated_masks[None, sel]))

    # ---- the clip ----
    def inpaint(self, frames_bgr: List[np.ndarray], mask: np.ndarray) -> List[np.ndarray]:
        """Equally sized BGR uint8 frames and an HxW{x1} mask -> the
        inpainted BGR uint8 frames, the whole frame as one band. H and W must
        be multiples of 8 (the band solver's multiple=8 sees to it). The
        input frames are not written."""
        with tracing.span("vsr.pp.clip", frames=len(frames_bgr)) as clip:
            with tracing.span("vsr.pp.prepare"):
                dilated = dilate_mask(mask, self.mask_dilation)
                H, W = dilated.shape
                plan = self._plan((0, H, 0, W), dilated, dilated)
            return self._inpaint_bands(frames_bgr, [plan], clip)

    @staticmethod
    def _mask_rows(mask: np.ndarray) -> Optional[Tuple[int, int]]:
        rows = np.nonzero(np.asarray(mask).any(axis=1))[0]
        if len(rows) == 0:
            return None
        return int(rows[0]), int(rows[-1]) + 1

    def _attention_windows(self, H: int, W: int) -> int:
        """Attention windows of a frame's token grid at band size H x W (the
        /4 encoding, the 7x7 stride-3 soft split, ceil window partition)."""
        wh, ww = self.generator.window_size
        fh, fw = (H // 4 - 1) // 3 + 1, (W // 4 - 1) // 3 + 1
        return -(-fh // wh) * -(-fw // ww)

    def _masked_window_set(self, mask2d: np.ndarray) -> Optional[np.ndarray]:
        """The attention windows that hold mask, for a mask that is the same
        in every frame: the generator's token-grid mask replayed on the host
        (nearest /4 downsample, 7x7 stride-3 max pool with padding 3, ceil
        window partition). None when every window holds mask (the set would
        skip nothing) or none does."""
        wh, ww = self.generator.window_size
        m = (np.asarray(mask2d) > 0)[::4, ::4]
        mp = np.pad(m, 3, constant_values=False)
        fh = (mp.shape[0] - 7) // 3 + 1
        fw = (mp.shape[1] - 7) // 3 + 1
        pooled = np.zeros((fh, fw), bool)
        for i in range(fh):
            for j in range(fw):
                pooled[i, j] = mp[3 * i:3 * i + 7, 3 * j:3 * j + 7].any()
        nwh, nww = -(-fh // wh), -(-fw // ww)
        padded = np.zeros((nwh * wh, nww * ww), bool)
        padded[:fh, :fw] = pooled
        occ = padded.reshape(nwh, wh, nww, ww).max(axis=(1, 3)).reshape(-1)
        idx = np.nonzero(occ)[0]
        if len(idx) == 0 or len(idx) == occ.size:
            return None
        return idx

    def _rgb(self, bgr: torch.Tensor) -> torch.Tensor:
        """[T, H, W, 3] BGR uint8 on the device -> [T, 3, H, W] RGB uint8."""
        return bgr.flip(-1).permute(0, 3, 1, 2).contiguous()

    def _stages(self, rgb: torch.Tensor, flow_mask: torch.Tensor, hole: torch.Tensor,
                rows: Tuple[int, int], masked_windows: Optional[torch.Tensor]) -> torch.Tensor:
        """The four device stages of one clip: rgb [T, 3, H, W] uint8 RGB,
        the flow and frame masks [H, W] float32 (the same for every frame)
        and the masked attention windows (None: all run both branches) on
        the device -> the composite's rows [r0, r1), [T, 3, r1 - r0, W]
        uint8 RGB on the device."""
        T, _, H, W = rgb.shape
        dev = self.device
        frames_n = rgb.float() / 255.0 * 2.0 - 1.0
        flow_masks = flow_mask[None, None].expand(T, 1, H, W)
        hole = hole[None]
        masks = hole[None].expand(T, 1, H, W)

        with tracing.device_span("vsr.pp.flows", dev) as flows:
            flows_f, flows_b = self._compute_flows(frames_n, flows)
        with tracing.device_span("vsr.pp.complete", dev,
                                 subvideos=len(range(0, T - 1, self.sub_video_length))):
            comp_f, comp_b = self._complete_flows(flows_f, flows_b, flow_masks)
            del flows_f, flows_b
        with tracing.device_span("vsr.pp.propagate", dev):
            updated_frames, updated_masks = self._propagate_images(frames_n, masks, comp_f,
                                                                   comp_b)
            del frames_n
        with tracing.device_span("vsr.pp.sweep", dev) as sweep:
            enc_all = self._encode_clip(updated_frames, masks, updated_masks)
            del updated_frames
            attention_windows = self._attention_windows(H, W)
            sweep.add(windows=len(self._windows(T)), attention_windows=attention_windows,
                      masked_windows=attention_windows if masked_windows is None
                      else len(masked_windows))
            return self._sweep_windows(enc_all, comp_f, comp_b, masks, updated_masks, rgb,
                                       hole > 0, rows, masked_windows)

    # ---- video outpainting (ref extrapolation :80-118) ----
    def outpaint(self, frames_bgr: List[np.ndarray],
                 scale: Tuple[float, float]) -> List[np.ndarray]:
        """Extend the field of view by scale=(sh, sw): the frames are centred
        on a larger canvas and the border is synthesised. The flow mask keeps
        a 4 px overlap into the known content when the border is wide
        (ref :105)."""
        n = len(frames_bgr)
        h, w = frames_bgr[0].shape[:2]
        eh = int(scale[0] * h) - int(scale[0] * h) % 8
        ew = int(scale[1] * w) - int(scale[1] * w) % 8
        y0, x0 = (eh - h) // 2, (ew - w) // 2
        canvas = np.zeros((n, eh, ew, 3), np.uint8)
        canvas[:, y0:y0 + h, x0:x0 + w] = np.stack(frames_bgr)
        dil_h = 4 if y0 > 10 else 0
        dil_w = 4 if x0 > 10 else 0
        flow_mask = np.ones((eh, ew), np.float32)
        flow_mask[y0 + dil_h:y0 + h - dil_h, x0 + dil_w:x0 + w - dil_w] = 0
        mask = np.ones((eh, ew), np.float32)
        mask[y0:y0 + h, x0:x0 + w] = 0
        with tracing.span("vsr.pp.clip", frames=n) as clip:
            with tracing.span("vsr.pp.prepare"):
                plan = self._plan((0, eh, 0, ew), flow_mask, mask)
            return self._inpaint_bands(list(canvas), [plan], clip)

    # ---- band video path (ref :363-418) ----
    def __call__(self, input_frames: List[np.ndarray], input_mask: np.ndarray) -> List[np.ndarray]:
        """Equally sized BGR uint8 frames and an HxW{x1} mask -> the frames
        with each of the mask's bands inpainted, in band order (band k reads
        the frames that hold bands < k). The input frames are not written."""
        mask = np.asarray(input_mask)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        with tracing.span("vsr.pp.clip", frames=len(input_frames)) as clip:
            with tracing.span("vsr.pp.prepare"):
                plans = self._band_plans(mask)
            return self._inpaint_bands(input_frames, plans, clip)

    @torch.inference_mode()
    def _inpaint_bands(self, input_frames: List[np.ndarray], plans: List[_Band],
                       clip) -> List[np.ndarray]:
        """The frames with each plan's band inpainted, in plan order (band k
        reads the frames that hold bands < k); ``clip``, the clip's span,
        counts the bands' pixels. The input frames are not written."""
        T = len(input_frames)
        frames = [np.ascontiguousarray(f) for f in input_frames]
        out = None
        for band in plans:
            ymin, ymax, xmin, xmax = band.box
            clip.add(band_px=(ymax - ymin) * (xmax - xmin))
            if band.rows is None:
                continue
            src = frames if out is None else out
            comp = self._inpaint_band(src, band)
            with tracing.span("vsr.pp.finish", frames=T) as finish:
                rows = self._fetch_rows(comp)
                del comp
                if out is None:  # every output byte is written once, here
                    out = [np.empty_like(f) for f in frames]
                finish.add(workers=native.compose_rows_batch(
                    src, out, rows, ymin + band.rows[0], xmin))
        return [f.copy() for f in input_frames] if out is None else out

    def _band_plans(self, mask: np.ndarray) -> List[_Band]:
        """The plans of an HxWx1 mask's bands, each band's dilated mask its
        flow and frame mask, made on the mask's first clip and kept by its
        bytes."""
        key = (mask.shape, mask.dtype.str, mask.tobytes())
        plans = self._plans.get(key)
        if plans is not None:
            return plans
        H, W = mask.shape[:2]
        plans = []
        for box in get_inpaint_area_by_mask(W, H, int(W * 3 / 16), mask, multiple=8):
            ymin, ymax, xmin, xmax = box
            dilated = dilate_mask(mask[ymin:ymax, xmin:xmax, 0], self.mask_dilation)
            plans.append(self._plan(box, dilated, dilated))
        if len(self._plans) >= MASKS_KEPT:
            del self._plans[next(iter(self._plans))]
        self._plans[key] = plans
        return plans

    def _plan(self, box: Tuple[int, int, int, int], flow_mask: np.ndarray,
              hole: np.ndarray) -> _Band:
        """The plan of the band ``box`` from its flow and frame masks, [h, w]
        float32 and the same for every frame (one tensor on the device where
        they are one array)."""
        dev = self.device
        hole_d = torch.from_numpy(hole).to(dev)
        flow_d = hole_d if flow_mask is hole else torch.from_numpy(flow_mask).to(dev)
        mw = self._masked_window_set(hole)
        return _Band(box, self._mask_rows(hole), flow_d, hole_d,
                     None if mw is None else torch.from_numpy(mw).to(dev))

    def _host_buffer(self, name: str, nbytes: int) -> Tuple[torch.Tensor, bool]:
        """The persistent flat uint8 host buffer ``name`` (pinned on a card)
        as ``nbytes`` of it, re-made only to hold more; (view, reused)."""
        buf = getattr(self, name)
        reused = buf is not None and buf.numel() >= nbytes
        if not reused:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
            setattr(self, name, buf)
        return buf[:nbytes], reused

    def _inpaint_band(self, frames: List[np.ndarray], band: _Band) -> torch.Tensor:
        """One band of a clip through the four stages: the crops go to the
        device through the persistent input buffer, in one native call ->
        the composite's rows that hold the dilated mask, on the device."""
        T, dev = len(frames), self.device
        ymin, ymax, xmin, xmax = band.box
        r0, r1 = band.rows
        with tracing.span("vsr.pp.prepare", frames=T) as prepare:
            crop_shape = (T, ymax - ymin, xmax - xmin, 3)
            host_in, in_kept = self._host_buffer("_host_in", math.prod(crop_shape))
            _, out_kept = self._host_buffer("_host_out", T * (r1 - r0) * (xmax - xmin) * 3)
            if self._h2d_done is not None:
                # the last clip's H2D from the buffer has ended (its D2H wait
                # saw to that, unless it raised between the two)
                self._h2d_done.synchronize()
            crops = host_in.view(crop_shape)
            workers = native.crop_batch(frames, ymin, xmin, crops.numpy())
            rgb = self._rgb(crops.to(dev, non_blocking=True))
            if dev.type == "cuda":
                self._h2d_done = torch.cuda.Event()
                self._h2d_done.record(torch.cuda.current_stream(dev))
            prepare.add(workers=workers, staged=int(in_kept and out_kept))
        return self._stages(rgb, band.flow_mask, band.hole, band.rows, band.masked_windows)

    def _fetch_rows(self, comp: torch.Tensor) -> np.ndarray:
        """The composite's rows [T, 3, rows, w] RGB on the device -> [T,
        rows, w, 3] BGR in the persistent output buffer (valid until the
        next clip), by one D2H and one wait."""
        rows = comp.flip(1).permute(0, 2, 3, 1).contiguous()
        host = self._host_out[:rows.numel()].view(rows.shape)
        host.copy_(rows, non_blocking=True)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        tracing.resolve_device_times()
        return host.numpy()
