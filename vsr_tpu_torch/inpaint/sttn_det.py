"""STTN-det inpainting mode: mask-aware temporal inpaint at 432x240.

Counterpart of ``vsr_tpu/inpaint/sttn_det.py`` (the reference's
backend/inpaint/sttn_det_inpaint.py:23-174). The band height is H*5/9
(portrait) or W*5/18 (landscape); each band crop and its hole mask are
resized to the model's size with cv2 on the host; the masked window engine
runs on ``device`` (encoder input with the hole zeroed, key gating by the
1/4-scale mask, predictions replacing only hole pixels before the overlap
average); the composite is blended back under the mask like the auto mode.
Both of the JAX package's deliberate divergences from the reference (one
colour space for prediction and source; a masked paste instead of
overwriting the whole band) hold here too.
"""

from __future__ import annotations

from typing import List, Optional, Union

import cv2
import numpy as np
import torch

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint.engine import STTNWindowEngine
from vsr_tpu_torch.inpaint.paste import band_out_rows, paste_band
from vsr_tpu_torch.inpaint.weights import load_sttn_weights
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
from vsr_tpu_torch.models.sttn import STTN_DET_INPUT_SIZE, STTNGenerator
from vsr_tpu_torch.parallel.mesh import default_inference_mesh, replicate
from vsr_tpu_torch.utils.device import resolve_device


class STTNDetInpainter:
    """Uniform inpainter contract: __call__(frames, mask) -> frames."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        config: Optional[Config] = None,
        input_size=STTN_DET_INPUT_SIZE,
        apply_attention_mask: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or Config()
        self._requested_device = device
        self.device = resolve_device(device)
        self.model_input_width, self.model_input_height = input_size
        model = STTNGenerator(variant="det", apply_attention_mask=apply_attention_mask,
                              use_kernel=self.config.use_pallas)
        load_sttn_weights(model, checkpoint_path)
        dtype = torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32
        self.model = model.to(self.device, dtype).eval()
        # one engine per (chunk length, output rows): short subtitle ranges
        # give short chunks, so this grows with the distinct range lengths
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
                masked=True,
                out_rows=out_rows,
                mesh=self._mesh(),
            )
        return self._engines[key]

    def _split_h(self, height: int, width: int) -> int:
        if height > width:
            return int(height * 5 / 9)
        return int(width * 5 / 18)

    def __call__(
        self, input_frames: List[np.ndarray], input_mask: np.ndarray
    ) -> List[np.ndarray]:
        mask = np.asarray(input_mask)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        H, W = mask.shape[:2]
        bands = get_inpaint_area_by_mask(W, H, self._split_h(H, W), mask)
        out = [f.copy() for f in input_frames]
        if not bands:
            return out

        size = (self.model_input_width, self.model_input_height)
        mask01 = (mask > 0).astype(np.uint8)
        for band in bands:
            ymin, ymax = band[0], band[1]
            scaled = np.stack(
                [cv2.resize(f[ymin:ymax, :, :], size) for f in input_frames])
            scaled_mask = cv2.resize(mask[ymin:ymax, :, :], size)
            binary = (scaled_mask > 0.5).astype(np.uint8)
            masks = np.repeat(binary[None], len(input_frames), axis=0)
            rows = band_out_rows(mask01, band, self.model_input_height)
            comps = self._inpaint_scaled(scaled, masks, rows)
            for j in range(len(out)):
                paste_band(out[j], comps[j], band, mask01, self.model_input_height, rows)
        return out

    def _inpaint_scaled(self, scaled: np.ndarray, masks: np.ndarray,
                        out_rows=None) -> np.ndarray:
        t = len(scaled)
        clip = min(self.config.get_sttn_max_load_num(),
                   max(t, self.config.sttn_reference_length))
        engine = self._engine(clip, out_rows)
        outs = []
        pending = []  # chunks in flight, as in vsr_tpu's sttn_det
        for s in range(0, t, clip):
            pending.append(engine.dispatch(scaled[s : s + clip], masks[s : s + clip]))
            if len(pending) > 2:
                outs.append(engine.fetch(pending.pop(0)))
        outs.extend(engine.fetch(h) for h in pending)
        return np.concatenate(outs, axis=0)
