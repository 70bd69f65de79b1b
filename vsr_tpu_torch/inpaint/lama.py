"""LaMa inpainting mode (PyTorch): counterpart of ``vsr_tpu/inpaint/lama.py``
(the reference's backend/inpaint/lama_inpaint.py:11-116).

* ``inpaint(image, mask)`` / ``inpaint_batch``, the picture path: one image
  at its own resolution, padded to a multiple of 8 by symmetric reflection
  (the reference's rule), the whole model output cropped back; batches of
  ``MINI_BATCH``, the tail padded with its last image.
* ``__call__(frames, mask)``, the video band path: full-width bands of
  height W*3/16 cover the mask; each band's crops go to the device in
  batches of ``BAND_BATCH`` (the tail padded with its last frame), the
  generator's upsampling tail runs only for the ``out_h`` rows from ``r0``
  that cover the mask (``out_rows``), the composite where(mask, prediction,
  input) is formed on the device for those rows, and the host copies back
  only mask pixels, so every other pixel stays the input's.

With a ``mesh`` (``parallel.mesh``), the band path's batch rounds up to a
multiple of the mesh size and each device's replica of the generator runs
its equal share of the batch's frames, uploaded from and downloaded to the
host directly; the picture path stays on the first device.

uint8 BGR crosses the bus both ways; normalization, clipping and the cast
run on the device. Transfers are pinned and asynchronous, with up to three
batches in flight (as the STTN engine does), so the host crops and pastes
while the card computes.

Differences from ``vsr_tpu``'s defaults, none from the reference: the
picture path pads to a multiple of 8 (``vsr_tpu`` pads to 64 unless
``VSR_LAMA_BUCKET=8``, to bound XLA compiles); the band path ships exact BGR
(``vsr_tpu``'s I420 codecs and its ``full`` band overwrite are TPU-link
workarounds). The outputs equal ``vsr_tpu``'s under ``VSR_LAMA_H2D=bgr``,
``VSR_LAMA_BAND_D2H=bgr`` and ``VSR_LAMA_BUCKET=8``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint.weights import load_lama_weights
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
from vsr_tpu_torch.models.lama import LamaGenerator
from vsr_tpu_torch.parallel.mesh import replicate
from vsr_tpu_torch.utils.device import resolve_device

MINI_BATCH = 4  # picture path (ref :38)
BAND_BATCH = 16  # video band path
PAD_MOD = 8  # the reference's pad-to-modulo (lama_util.py:59)
OUT_ROWS_BUCKET = 64  # the band path's returned rows: a multiple of 64


def pad_to_modulo(arr: np.ndarray) -> np.ndarray:
    """Bottom/right symmetric-reflection pad to the next multiple of
    PAD_MOD, as the reference's np.pad(mode='symmetric')."""
    h, w = arr.shape[:2]
    ph = (PAD_MOD - h % PAD_MOD) % PAD_MOD
    pw = (PAD_MOD - w % PAD_MOD) % PAD_MOD
    if ph == 0 and pw == 0:
        return arr
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad, mode="symmetric")


class LamaInpainter:
    """Uniform inpainter contract: __call__(frames, mask) -> frames."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        config: Optional[Config] = None,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self.config = config or Config()
        self.device = resolve_device(device)
        model = LamaGenerator()
        load_lama_weights(model, checkpoint_path)
        dtype = torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32
        self.model = model.to(self.device, dtype).eval()
        # the band path's replicas, one per mesh device (None: the model alone)
        self.replicas = replicate(self.model, mesh) if mesh else None

    # ---- transfers ----
    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _stage(self, arrays: Sequence[np.ndarray], batch: int) -> torch.Tensor:
        """The arrays stacked into a (pinned) uint8 buffer of ``batch``
        rows, the tail repeating the last array."""
        buf = torch.empty((batch, *arrays[0].shape), dtype=torch.uint8, pin_memory=self._cuda)
        view = buf.numpy()
        for i, a in enumerate(arrays):
            view[i] = a
        view[len(arrays):] = arrays[-1]
        return buf

    def _upload(self, host: torch.Tensor, device: Optional[torch.device] = None) -> torch.Tensor:
        """Asynchronous H2D of a staged buffer to ``device`` (default: the
        inpainter's; a no-op on the CPU)."""
        return host.to(device or self.device, non_blocking=True)

    def _download(self, out: torch.Tensor):
        """Enqueue the copy of ``out`` into pinned host memory; returns
        (host tensor, event to wait on)."""
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=self._cuda)
        host.copy_(out, non_blocking=True)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
        return host, done

    @staticmethod
    def _wait(download) -> np.ndarray:
        host, done = download
        if done is not None:
            done.synchronize()
        return host.numpy()

    # ---- device programs ----
    @torch.inference_mode()
    def _forward(self, img_u8: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8, [B or 1, H, W, 1] uint8 -> [B, H, W, 3] uint8."""
        img = img_u8.float() / 255.0
        msk = (mask_u8 > 0).float().expand(*img.shape[:3], 1)
        return (self.model(img, msk) * 255.0).clamp(0, 255).to(torch.uint8)

    @torch.inference_mode()
    def _band_forward(self, model, img_u8: torch.Tensor, mask_u8: torch.Tensor, r0: int,
                      out_h: int, out_w: int) -> torch.Tensor:
        """The composite rows [r0, r0 + out_h) of a band batch through
        ``model`` (a replica on the batch's device): the prediction inside
        the mask, the input elsewhere, [B, out_h, out_w, 3]."""
        img = img_u8.float() / 255.0
        mskb = mask_u8 > 0  # [1, H, W, 1]
        msk = mskb.float().expand(*img.shape[:3], 1)
        if out_h % 2 == 0:
            pred = model(img, msk, out_rows=(r0, out_h))
        else:  # odd out_h (a band shorter than 64 rows): full output
            pred = model(img, msk)[:, r0:r0 + out_h]
        pred_u8 = (pred * 255.0).clamp(0, 255).to(torch.uint8)
        comp = torch.where(mskb[:, r0:r0 + out_h], pred_u8, img_u8[:, r0:r0 + out_h])
        return comp[:, :, :out_w]

    # ---- picture path ----
    def _dispatch_batch(self, images: List[np.ndarray], masks: List[np.ndarray]):
        """Enqueue one batch of equally sized images; returns a handle."""
        orig_h, orig_w = images[0].shape[:2]
        img = self._stage([pad_to_modulo(im) for im in images], len(images))
        msk = self._stage([pad_to_modulo(np.asarray(m).squeeze()[..., None]) for m in masks],
                          len(masks))
        out = self._forward(self._upload(img), self._upload(msk))
        # the staged inputs stay referenced until the fetch: their copies
        # may still be in flight
        return self._download(out), orig_h, orig_w, (img, msk)

    def _fetch_batch(self, handle, n: int) -> List[np.ndarray]:
        download, orig_h, orig_w, _ = handle
        arr = self._wait(download)
        return [arr[i, :orig_h, :orig_w].copy() for i in range(n)]

    def inpaint(self, image: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One HWC uint8 BGR image and its HW (or HW1) uint8 mask -> the
        inpainted image at the input's size (ref :17-28)."""
        return self._fetch_batch(self._dispatch_batch([image], [mask]), 1)[0]

    def inpaint_batch(self, images: List[np.ndarray],
                      masks: List[np.ndarray]) -> List[np.ndarray]:
        """Equally sized images in batches of MINI_BATCH (the tail padded
        with its last image), up to three batches in flight."""
        if len(images) == 1:
            return [self.inpaint(images[0], masks[0])]
        results: List[np.ndarray] = []
        pending: List[tuple] = []
        for start in range(0, len(images), MINI_BATCH):
            chunk = images[start:start + MINI_BATCH]
            mchunk = masks[start:start + MINI_BATCH]
            n = len(chunk)
            chunk = chunk + [chunk[-1]] * (MINI_BATCH - n)
            mchunk = mchunk + [mchunk[-1]] * (MINI_BATCH - n)
            pending.append((self._dispatch_batch(chunk, mchunk), n))
            if len(pending) > 2:
                results.extend(self._fetch_batch(*pending.pop(0)))
        for handle, n in pending:
            results.extend(self._fetch_batch(handle, n))
        return results

    # ---- video band path (ref :69-116) ----
    def __call__(self, input_frames: List[np.ndarray], input_mask: np.ndarray) -> List[np.ndarray]:
        mask = np.asarray(input_mask)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        H, W = mask.shape[:2]
        bands = get_inpaint_area_by_mask(W, H, int(W * 3 / 16), mask)
        out = [f.copy() for f in input_frames]
        for band in bands:
            self._inpaint_band(out, mask, band[0], band[1])
        return out

    def band_geometry(self, mask: np.ndarray, ymin: int, ymax: int):
        """(r0, out_h) of the rows the band path returns for the band
        [ymin, ymax) of ``mask`` [H, W, 1]: out_h a multiple of 64 (or the
        band's height) covering the mask's rows, r0 clamped into the band;
        None when the band holds no mask pixel."""
        orig_h = ymax - ymin
        mrows = np.nonzero(mask[ymin:ymax, :, 0].any(axis=1))[0]
        if len(mrows) == 0:
            return None
        out_h = min(orig_h, (int(mrows[-1] - mrows[0]) // OUT_ROWS_BUCKET + 1) * OUT_ROWS_BUCKET)
        return max(0, min(int(mrows[0]), orig_h - out_h)), out_h

    def _inpaint_band(self, out: List[np.ndarray], mask: np.ndarray,
                      ymin: int, ymax: int) -> None:
        """Inpaint one horizontal band in place across all frames."""
        geometry = self.band_geometry(mask, ymin, ymax)
        if geometry is None:
            return
        r0, out_h = geometry
        width = out[0].shape[1]
        y0 = ymin + r0
        hole3 = mask[y0:y0 + out_h] > 0  # [out_h, W, 1]
        # the band mask is the same for every frame: on each device once (its
        # pinned staging lives to the end of the band, past its copies)
        host_mask = self._stage([pad_to_modulo(mask[ymin:ymax])], 1)
        replicas = self.replicas or [self.model]
        devices = [next(m.parameters()).device for m in replicas]
        d_mask = {dev: self._upload(host_mask, dev) for dev in devices}
        # each replica takes an equal share of every batch
        share = -(-BAND_BATCH // len(replicas))
        batch = share * len(replicas)

        def finish(downloads, start: int, k: int, _staged) -> None:
            parts = [self._wait(d) for d in downloads]
            rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._paste(out[start:start + k], rows[:k], y0, hole3)

        pending: List[tuple] = []
        for start in range(0, len(out), batch):
            k = min(batch, len(out) - start)
            staged = self._stage(
                [pad_to_modulo(out[j][ymin:ymax]) for j in range(start, start + k)], batch)
            downloads = [
                self._download(self._band_forward(
                    model, self._upload(staged[i * share:(i + 1) * share], dev), d_mask[dev],
                    r0, out_h, width))
                for i, (model, dev) in enumerate(zip(replicas, devices))]
            pending.append((downloads, start, k, staged))
            if len(pending) > 2:
                finish(*pending.pop(0))
        for item in pending:
            finish(*item)

    @staticmethod
    def _paste(frames: List[np.ndarray], rows: np.ndarray, y0: int, hole3: np.ndarray) -> None:
        """Copy only the mask pixels of each frame's composite rows into the
        frame's rows [y0, y0 + out_h): every other pixel keeps its bytes."""
        for frame, r in zip(frames, rows):
            np.copyto(frame[y0:y0 + len(hole3)], r, where=hole3)
