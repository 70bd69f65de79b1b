"""STTN-auto inpainting mode: fixed-mask temporal inpaint, no detection.

Counterpart of ``vsr_tpu/inpaint/sttn_auto.py``. The mask's full-width bands
of height W*3/16 are cropped and resized to the model's 640x120 on the host,
inpainted on ``device`` by the window engine, and blended back under the
mask. Video streams through in chunks of ``clip_gap`` frames with two chunks
in flight: the host prepares and pastes one while the device runs the other.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from vsr_tpu_torch import native
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint.engine import STTNWindowEngine
# paste_band stays importable from here: the benchmark's traced run wraps
# the names it finds on this module
from vsr_tpu_torch.inpaint.paste import band_out_rows, paste_band, paste_band_chunk  # noqa: F401
from vsr_tpu_torch.inpaint.weights import load_sttn_weights
from vsr_tpu_torch.masks.intervals import is_frame_number_in_ab_sections
from vsr_tpu_torch.masks.mask import binarize_mask
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
from vsr_tpu_torch.models.sttn import STTN_AUTO_INPUT_SIZE, STTNGenerator
from vsr_tpu_torch.parallel.mesh import default_inference_mesh, replicate
from vsr_tpu_torch.utils import tracing
from vsr_tpu_torch.utils.device import adaptive_clip_len, resolve_device


class STTNAutoInpainter:
    """Uniform inpainter contract: __call__(frames, mask) -> frames, plus
    process_video() for the streaming chunked path of the pipeline."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        config: Optional[Config] = None,
        input_size=STTN_AUTO_INPUT_SIZE,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or Config()
        self._requested_device = device
        self.device = resolve_device(device)
        self.model_input_width, self.model_input_height = input_size
        model = STTNGenerator(variant="auto", use_kernel=self.config.use_pallas)
        load_sttn_weights(model, checkpoint_path)
        dtype = torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32
        self.model = model.to(self.device, dtype).eval()
        self.clip_gap = adaptive_clip_len(
            self.device, self.config.get_sttn_max_load_num(),
            self.model_input_height, self.model_input_width,
            minimum=self.config.sttn_reference_length,
        )
        self._engines = {}
        self._replicas = None

    def _mesh(self):
        """Model replicas over default_inference_mesh (every visible card when
        the caller asked for "cuda" and there are several), made once; None
        on one device."""
        if self._replicas is None:
            mesh = default_inference_mesh(self._requested_device)
            self._replicas = replicate(self.model, mesh) if mesh else []
        return self._replicas or None

    def _engine(self, clip_len: int, out_rows=None) -> STTNWindowEngine:
        """One engine per (chunk length, output slice)."""
        key = (clip_len, out_rows)
        if key not in self._engines:
            self._engines[key] = STTNWindowEngine(
                self.model,
                self.device,
                clip_len=clip_len,
                input_hw=(self.model_input_height, self.model_input_width),
                stride=self.config.sttn_neighbor_stride,
                ref_length=self.config.sttn_reference_length,
                window_batch=self.config.window_batch,
                out_rows=out_rows,
                mesh=self._mesh(),
            )
        return self._engines[key]

    # ---- band helpers ----
    def _split_h(self, width: int) -> int:
        return int(width * 3 / 16)

    def _stack_band(self, frames: List[np.ndarray], band) -> np.ndarray:
        """Crop+resize a chunk into one [T, h, w, 3] buffer, in one native
        call that shares the frames among the pool's workers."""
        ymin, ymax, _, _ = band
        buf = np.empty((len(frames), self.model_input_height,
                        self.model_input_width, 3), np.uint8)
        with tracing.span("vsr.crop_resize", frames=len(frames), bytes=buf.nbytes) as crop:
            crop.add(workers=native.crop_resize_batch(
                [np.ascontiguousarray(f) for f in frames], ymin, ymax - ymin, buf))
        return buf

    def _paste_chunk(self, frames: List[np.ndarray], comps: np.ndarray, band,
                     mask01: np.ndarray, out_rows) -> None:
        """Blend a chunk's composites of one band back into its frames, in
        place, in one native call."""
        with tracing.span("vsr.paste", frames=len(frames)) as paste:
            paste.add(workers=paste_band_chunk(frames, comps, band, mask01,
                                               self.model_input_height, out_rows))

    # ---- list-in/list-out contract ----
    def __call__(
        self, input_frames: List[np.ndarray], input_mask: np.ndarray
    ) -> List[np.ndarray]:
        """Inpaint a list of frames under one mask, band by band, with up to
        two chunks in flight on the device."""
        mask01 = binarize_mask(input_mask)
        H, W = mask01.shape[:2]
        bands = get_inpaint_area_by_mask(W, H, self._split_h(W), mask01)
        out = [f.copy() for f in input_frames]
        t = len(input_frames)
        for band in bands:
            out_rows = band_out_rows(mask01, band, self.model_input_height)
            clip = min(self.clip_gap,
                       max(t, self.config.sttn_reference_length))
            engine = self._engine(clip, out_rows)

            def drain(item):
                start, handle = item
                comps = engine.fetch(handle)
                self._paste_chunk(out[start : start + len(comps)], comps, band,
                                  mask01, out_rows)

            pending = []
            for s in range(0, t, clip):
                scaled = self._stack_band(input_frames[s : s + clip], band)
                pending.append((s, engine.dispatch(scaled)))
                if len(pending) > 2:
                    drain(pending.pop(0))
            for item in pending:
                drain(item)
        return out

    # ---- streaming video path ----
    def process_video(
        self,
        reader,
        writer,
        input_mask: np.ndarray,
        frame_count: int,
        size,  # (W, H)
        ab_sections=None,
        progress_cb: Optional[Callable[[int], None]] = None,
        preview_cb: Optional[Callable[[np.ndarray, np.ndarray], None]] = None,
    ) -> int:
        """Stream the whole video through chunked band inpainting.

        reader: object with read() -> (ok, BGR frame); writer: write(frame).
        Returns the number of frames written. While the device runs chunk i,
        the host pastes back and writes chunk i-1.
        """
        with tracing.span("vsr.process_video") as whole:
            written = self._process_video(reader, writer, input_mask, frame_count, size,
                                          ab_sections, progress_cb, preview_cb)
            whole.add(frames=written)
        return written

    def _process_video(self, reader, writer, input_mask, frame_count, size, ab_sections,
                       progress_cb, preview_cb) -> int:
        W, H = size
        mask01 = binarize_mask(input_mask)
        bands = get_inpaint_area_by_mask(W, H, self._split_h(W), mask01)
        clip = self.clip_gap
        band_rows = [band_out_rows(mask01, band, self.model_input_height)
                     for band in bands]
        engines = [self._engine(clip, rows) for rows in band_rows]

        def read_chunk(chunk):
            frames_hr: List[np.ndarray] = []
            in_section: List[bool] = []
            nonlocal frame_no
            with tracing.span("vsr.read", chunk) as read:
                # cap at frame_count: the container's frame count can
                # undercount and the writer/audio mux must stay in sync with it
                while len(frames_hr) < clip and frame_no < frame_count:
                    ok, frame = reader.read()
                    if not ok:
                        break
                    frames_hr.append(frame)
                    in_section.append(
                        is_frame_number_in_ab_sections(frame_no, ab_sections))
                    frame_no += 1
                read.add(frames=len(frames_hr))
            return frames_hr, in_section

        def dispatch_chunk(chunk, frames_hr, in_section):
            proc_idx = [i for i, p in enumerate(in_section) if p]
            handles = []
            with tracing.span("vsr.submit", chunk):
                if bands and proc_idx:
                    for band, engine in zip(bands, engines):
                        scaled = self._stack_band(
                            [frames_hr[i] for i in proc_idx], band)
                        handles.append(engine.dispatch(scaled))
            return chunk, frames_hr, proc_idx, handles

        def drain_chunk(chunk, frames_hr, proc_idx, handles) -> int:
            with tracing.span("vsr.drain", chunk, frames=len(frames_hr)):
                comps_per_band = [engine.fetch(h)
                                  for engine, h in zip(engines, handles)]
                originals = [f.copy() for f in frames_hr] if preview_cb else None
                processed = [frames_hr[i] for i in proc_idx]
                for band, rows, comps in zip(bands, band_rows, comps_per_band):
                    self._paste_chunk(processed, comps, band, mask01, rows)
                n = 0
                for i, frame in enumerate(frames_hr):
                    with tracing.span("vsr.write", frames=1):
                        writer.write(frame)
                    n += 1
                    if progress_cb:
                        progress_cb(1)
                    if preview_cb:
                        preview_cb(originals[i], frame)
            return n

        written = 0
        frame_no = 0
        chunk = 0  # chunk ids for the spans, from 0 in each call
        pending = None
        while written + (len(pending[1]) if pending else 0) < frame_count:
            frames_hr, in_section = read_chunk(chunk)
            if not frames_hr:
                break
            current = dispatch_chunk(chunk, frames_hr, in_section)
            if pending is not None:
                written += drain_chunk(*pending)
            pending = current
            chunk += 1
            if len(frames_hr) < clip:
                break  # reader exhausted
        if pending is not None:
            written += drain_chunk(*pending)
        return written
