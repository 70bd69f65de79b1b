"""Fixed-shape temporal window engine for STTN inference (PyTorch).

Counterpart of ``vsr_tpu/inpaint/engine.py``. Per chunk of ``clip_len``
frames (the tail padded by repeating the last frame): encode every frame
once, gather each window's neighbour and reference slots from a host-built
index, run the transformer over a batch of windows with padded slots masked
out of the keys, decode the neighbour slots only, and composite the
overlapping windows per frame in the reference's order (first window
truncates to uint8, later ones blend 0.5/0.5, final truncation). Only the
composited uint8 rows that the mask needs cross back to the host.

The ``masked`` engine (STTN-det) also takes a {0,1} hole mask per frame: the
encoder sees the frames with the hole zeroed, the transformer's key gating
sees the mask at feature scale (nearest, every 4th pixel), and each window's
prediction replaces only hole pixels of the model-size source frame before
the overlap average.

With a ``mesh`` (one model replica per device, ``parallel.mesh.replicate``)
the windows, which are independent once the chunk is encoded, are split
into one contiguous shard per replica, padded to equal shards with
all-invalid windows as ``vsr_tpu``'s mesh engine pads them: each shard's
window features are gathered on the first device and copied to its
replica, which runs the transformer and the decoder and sends its uint8
predictions back; the composite stays on the first device, in window order.

``dispatch``/``fetch`` keep the work asynchronous: dispatch copies the chunk
from pinned host memory, enqueues the compute and the copy back into a
pinned output buffer on the current stream and records an event; fetch
waits on that event. Each dispatched chunk owns its pinned buffers, so
chunks in flight never share one.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_OVERLAPS = 3  # a frame is covered by at most 3 windows (stride-5 windows span ±5)


def window_starts(t: int, stride: int) -> List[int]:
    return list(range(0, t, stride))


def neighbor_ids(f: int, t: int, stride: int) -> List[int]:
    """Window at f covers [f-stride, f+stride] clamped."""
    return list(range(max(0, f - stride), min(t, f + stride + 1)))


def ref_ids(neighbors: List[int], t: int, ref_length: int) -> List[int]:
    """Global refs every ref_length frames, excluding neighbors."""
    ns = set(neighbors)
    return [i for i in range(0, t, ref_length) if i not in ns]


def build_window_index(
    t_valid: int,
    t_padded: int,
    stride: int,
    ref_length: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Build gather indices for all windows of a chunk.

    Returns (idx [Wn, L] int32, valid [Wn, L] bool, n_max). Slot layout per
    window: [n_max neighbor slots | r_max reference slots]. Wn and L depend
    only on (t_padded, stride, ref_length); t_valid only changes the values.
    """
    n_max = 2 * stride + 1
    r_max = math.ceil(t_padded / ref_length)
    wn = math.ceil(t_padded / stride)
    L = n_max + r_max
    idx = np.zeros((wn, L), np.int32)
    valid = np.zeros((wn, L), bool)
    for w, f in enumerate(window_starts(t_padded, stride)):
        if f >= t_valid:
            continue  # fully padded window; outputs discarded
        ns = neighbor_ids(f, t_valid, stride)
        rs = ref_ids(ns, t_valid, ref_length)
        idx[w, : len(ns)] = ns
        valid[w, : len(ns)] = True
        idx[w, n_max : n_max + len(rs)] = rs
        valid[w, n_max : n_max + len(rs)] = True
    return idx, valid, n_max


def build_composite_index(
    t_valid: int, t_padded: int, stride: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame contribution map for the composite.

    Returns (fwin [T, K], fslot [T, K], fcount [T]): for each frame, the
    windows covering it (ascending — the reference's sequential blend order)
    and the neighbor slot holding its prediction.
    """
    fwin = np.zeros((t_padded, MAX_OVERLAPS), np.int32)
    fslot = np.zeros((t_padded, MAX_OVERLAPS), np.int32)
    fcount = np.zeros((t_padded,), np.int32)
    for w, f in enumerate(window_starts(t_valid, stride)):
        for slot, frame_idx in enumerate(neighbor_ids(f, t_valid, stride)):
            k = fcount[frame_idx]
            assert k < MAX_OVERLAPS, "window stride/overlap invariant violated"
            fwin[frame_idx, k] = w
            fslot[frame_idx, k] = slot
            fcount[frame_idx] += 1
    return fwin, fslot, fcount


def _auto_window_batch(num_windows: int, requested: int) -> int:
    """Largest divisor of num_windows that is <= requested (no padded windows)."""
    if requested <= 0 or requested >= num_windows:
        return num_windows
    for wb in range(requested, 0, -1):
        if num_windows % wb == 0:
            return wb
    return 1


class STTNWindowEngine:
    """Chunk processor around an STTNGenerator that lives on ``device``."""

    def __init__(
        self,
        model,
        device: torch.device,
        clip_len: int,
        input_hw: Tuple[int, int],
        stride: int = 5,
        ref_length: int = 10,
        window_batch: int = 0,
        masked: bool = False,
        out_rows: Optional[Tuple[int, int]] = None,
        mesh: Optional[Sequence[torch.nn.Module]] = None,
    ):
        self.model = model
        self.device = device
        self.clip_len = clip_len
        self.input_hw = input_hw
        self.stride = stride
        self.ref_length = ref_length
        self.masked = masked  # det variant: masked encoder input + attention
        # out_rows: (r0, r1) rows of the composited band to return; the
        # caller picks them with margin for the paste's interpolation.
        self.out_rows = out_rows
        self.n_max = 2 * stride + 1
        self.num_windows = math.ceil(clip_len / stride)
        # mesh: the replicas, one per mesh device (entries may repeat one)
        self.mesh = list(mesh) if mesh else None
        if self.mesh:
            n = len(self.mesh)
            self.num_windows_sharded = math.ceil(self.num_windows / n) * n
            self.window_batch = _auto_window_batch(self.num_windows_sharded // n, window_batch)
        else:
            self.num_windows_sharded = self.num_windows
            self.window_batch = _auto_window_batch(self.num_windows, window_batch)

    # ---- device program ----
    @torch.inference_mode()
    def _chunk_step(self, frames_u8, idx, valid, fwin, fslot, fcount, masks=None):
        """frames_u8: [T, H, W, 3] BGR uint8; idx/valid: [Wn, L];
        fwin/fslot/fcount: composite index (build_composite_index);
        masks (masked engine): [T, H, W] {0,1} uint8 hole masks.

        Returns the composited [T, rows, W, 3] BGR uint8 (rows = out_rows).
        """
        x = frames_u8.flip(-1).float() / 255.0 * 2.0 - 1.0  # RGB in [-1, 1]
        feat_masks = None
        if masks is not None:
            masks = masks.float()
            # hole pixels leave the encoder input (ref sttn_det_inpaint.py:143)
            # and the nearest-1/4 mask gates the attention keys
            x = x * (1.0 - masks[..., None])
            feat_masks = masks[:, ::4, ::4]
        feats = self.model.encode(x)  # [T, h, w, C]
        if self.mesh is None:
            preds_u8 = self._predict(self.model, feats, feat_masks, idx, valid)
        else:
            preds_u8 = self._predict_sharded(feats, feat_masks, idx, valid)

        r0, r1 = self.out_rows if self.out_rows is not None else (0, x.shape[1])

        # per-frame contributions in window order: [T, K, rows, W, 3]
        contrib = preds_u8[fwin, fslot].float()
        if masks is not None:
            # the prediction replaces only hole pixels of the source, before
            # the overlap average (ref sttn_det_inpaint.py:168)
            m = masks[:, None, r0:r1, :, None]
            contrib = contrib * m + frames_u8[:, None, r0:r1].float() * (1.0 - m)
        comp = contrib[:, 0]
        for k in range(1, MAX_OVERLAPS):
            take = (fcount > k)[:, None, None, None]
            comp = torch.where(take, 0.5 * comp + 0.5 * contrib[:, k], comp)
        return comp.to(torch.uint8)

    def _predict(self, model, feats, feat_masks, idx, valid) -> torch.Tensor:
        """The windows idx/valid [W, L] through ``model`` on the device of
        ``feats``, in window batches: [W, n_max, rows, W, 3] BGR uint8."""
        preds = []
        wb = self.window_batch
        for w0 in range(0, idx.shape[0], wb):
            widx, wvalid = idx[w0 : w0 + wb], valid[w0 : w0 + wb]
            # invalid slots carry clamped-index (finite) features; the key
            # mask keeps them out of attention and they are never composited
            wmask = feat_masks[widx] if feat_masks is not None else None
            out = model.transform(feats[widx], wvalid, wmask)
            nb = out[:, : self.n_max]  # neighbour slots only
            n, h, w, c = nb.shape[1:]
            dec = model.decode(nb.reshape(-1, h, w, c))
            preds.append(dec.reshape(-1, n, *dec.shape[1:]))
        preds = torch.cat(preds)  # [W, n_max, H, W, 3]
        preds_u8 = ((preds + 1.0) * 0.5 * 255.0).clamp(0, 255).to(torch.uint8)
        r0, r1 = self.out_rows if self.out_rows is not None else (0, preds_u8.shape[2])
        return preds_u8.flip(-1)[:, :, r0:r1]  # RGB -> BGR

    def _predict_sharded(self, feats, feat_masks, idx, valid) -> torch.Tensor:
        """_predict over the mesh: the windows (padded with all-invalid ones
        to num_windows_sharded) in one contiguous shard per replica. Every
        shard's inputs are gathered and sent before any shard is computed,
        so no copy waits behind the first device's own shard; the
        predictions come back to the first device."""
        extra = self.num_windows_sharded - idx.shape[0]
        idx = torch.cat([idx, idx.new_zeros((extra, idx.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros((extra, valid.shape[1]))])
        per = idx.shape[0] // len(self.mesh)
        work = []
        for i, replica in enumerate(self.mesh):
            dev = next(replica.parameters()).device
            sidx = idx[i * per : (i + 1) * per]
            local = torch.arange(sidx.numel(), device=dev).reshape(sidx.shape)
            sfeats = feats[sidx].flatten(0, 1).to(dev, non_blocking=True)
            smasks = None
            if feat_masks is not None:
                smasks = feat_masks[sidx].flatten(0, 1).to(dev, non_blocking=True)
            svalid = valid[i * per : (i + 1) * per].to(dev, non_blocking=True)
            work.append((replica, sfeats, smasks, local, svalid))
        return torch.cat([self._predict(*w).to(self.device, non_blocking=True) for w in work])

    # ---- host side ----
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Asynchronous H2D of a small host array: pinned staging, because a
        copy from pageable memory may wait for the stream."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _pinned(self, a: np.ndarray, pin: bool) -> torch.Tensor:
        """a [T', ...] uint8 in a (pinned) [clip_len, ...] buffer, the tail
        padded by repeating a[-1]."""
        buf = torch.empty((self.clip_len, *a.shape[1:]), dtype=torch.uint8, pin_memory=pin)
        view = buf.numpy()
        view[:len(a)] = a
        view[len(a):] = a[-1]
        return buf

    def dispatch(self, frames: np.ndarray, masks: Optional[np.ndarray] = None):
        """Enqueue one chunk; returns an opaque handle for fetch().

        frames: [T', H, W, 3] BGR uint8 with T' <= clip_len (model input size);
        masks (masked engine only): [T', H, W] {0,1} hole masks.
        """
        t_valid = len(frames)
        if not 0 < t_valid <= self.clip_len:
            raise ValueError(f"chunk of {t_valid} frames for clip_len {self.clip_len}")
        h, w = self.input_hw
        if frames.shape[1:] != (h, w, 3):
            raise ValueError(f"frames {frames.shape[1:]} are not model size {(h, w, 3)}")
        if (masks is not None) != self.masked:
            raise ValueError("a masked engine takes hole masks, an unmasked one none")
        if masks is not None and masks.shape != (t_valid, h, w):
            raise ValueError(f"masks {masks.shape} are not {(t_valid, h, w)}")
        cuda = self.device.type == "cuda"

        host_in = self._pinned(frames, cuda)
        host_masks = None
        if masks is not None:
            host_masks = self._pinned((masks > 0).astype(np.uint8), cuda)

        idx, valid, _ = build_window_index(
            t_valid, self.clip_len, self.stride, self.ref_length)
        fwin, fslot, fcount = build_composite_index(t_valid, self.clip_len, self.stride)
        index = [self._to_device(a) for a in (idx.astype(np.int64), valid,
                                              fwin.astype(np.int64),
                                              fslot.astype(np.int64), fcount)]

        frames_dev = host_in.to(self.device, non_blocking=True)
        masks_dev = None
        if host_masks is not None:
            masks_dev = host_masks.to(self.device, non_blocking=True)
        out = self._chunk_step(frames_dev, *index, masks=masks_dev)
        host_out = torch.empty(out.shape, dtype=torch.uint8, pin_memory=cuda)
        host_out.copy_(out, non_blocking=True)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        # the pinned inputs stay referenced until fetch: their copies may
        # still be in flight
        return host_out, done, t_valid, (host_in, host_masks)

    def fetch(self, handle) -> np.ndarray:
        """Wait for a dispatched chunk; returns [T', rows, W, 3] BGR uint8."""
        host_out, done, t_valid, _ = handle
        if done is not None:
            done.synchronize()
        return host_out.numpy()[:t_valid]

    def process_chunk(self, frames: np.ndarray,
                      masks: Optional[np.ndarray] = None) -> np.ndarray:
        """Synchronous dispatch+fetch."""
        return self.fetch(self.dispatch(frames, masks))
