"""Pipeline orchestrator of the port: counterpart of ``vsr_tpu/pipeline.py``'s
SubtitleRemover (the reference's backend/main.py).

Owns video and picture I/O, runs the detector and the inpainters on an
explicit device, tracks progress and remuxes the source audio into the
output. Modes:

* STTN_AUTO — fixed-area streaming temporal inpaint (ref main.py:247-258)
* STTN_DET / LAMA / OPENCV — detection-driven batch inpaint (ref
  main.py:260-333)
* PROPAINTER — detection, scene split, ProPainter batches and LaMa for
  single frames (ref main.py:159-245)
* picture input — detection + LaMa on one image (ref main.py:353-371)
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import cv2
import numpy as np
import torch

from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.i18n import tr
from vsr_tpu_torch.io.audio import merge_audio_to_video
from vsr_tpu_torch.io.video import FramePrefetcher, VideoReader, VideoWriter, read_video_info
from vsr_tpu_torch.masks.intervals import (
    batch_generator,
    expand_frame_ranges,
    filter_and_merge_intervals,
    find_continuous_ranges_with_same_mask,
    split_range_by_scene,
)
from vsr_tpu_torch.masks.mask import create_mask
from vsr_tpu_torch.utils.common import IMAGE_EXTENSIONS, is_image_file  # noqa: F401
from vsr_tpu_torch.utils.device import resolve_device


class SubtitleRemover:
    def __init__(
        self,
        video_path: str,
        output_path: Optional[str] = None,
        sub_areas: Optional[Sequence[Tuple[int, int, int, int]]] = None,
        config: Optional[Config] = None,
        checkpoint_dir: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.video_path = str(video_path)
        # the STTN inpainters get the device as asked: a bare "cuda" spreads
        # their windows over every visible card (parallel.mesh)
        self.requested_device = device
        self.device = resolve_device(device)
        self.config = config or Config()
        self.checkpoint_dir = checkpoint_dir or os.environ.get("VSR_TPU_MODELS", "")
        self.is_picture = is_image_file(self.video_path)
        self.vd_name = Path(self.video_path).stem
        self.ext = os.path.splitext(self.video_path)[-1]

        if self.is_picture:
            img = cv2.imread(self.video_path)
            if img is None:
                raise IOError(f"cannot read image: {self.video_path}")
            self.frame_height, self.frame_width = img.shape[:2]
            self.fps, self.frame_count = 0.0, 1
        else:
            info = read_video_info(self.video_path)
            self.frame_width, self.frame_height = info.width, info.height
            self.fps, self.frame_count = info.fps, info.frame_count
        self.size = (self.frame_width, self.frame_height)
        self.mask_size = (self.frame_height, self.frame_width)

        # ymin, ymax, xmin, xmax boxes; empty -> full frame (ref main.py:338-340)
        self.sub_areas: List[Tuple[int, int, int, int]] = list(sub_areas or [])
        # frame ranges to process (None: all); sttn-auto passes the frames
        # outside them through, the detector samples only inside them
        self.ab_sections: Optional[List[range]] = None

        if output_path:
            self.video_out_path = os.path.abspath(output_path)
        elif self.is_picture:
            self.video_out_path = os.path.abspath(os.path.join(
                os.path.dirname(self.video_path), "no_sub", f"{self.vd_name}{self.ext}"))
        else:
            self.video_out_path = os.path.abspath(os.path.join(
                os.path.dirname(self.video_path),
                f"{Path(self.video_path).stem}_no_sub.mp4"))

        self.progress_total = 0
        self.is_finished = False
        self.is_successful_merged = False
        self.progress_listeners: List[Callable[[int, bool], None]] = []
        self.preview_cb: Optional[Callable[[np.ndarray, np.ndarray], None]] = None
        self._frames_done = 0

        self._sttn_auto = None
        self._sttn_det = None
        self._lama = None
        self._propainter = None
        self._detector = None

    # ---- observability ----
    def append_output(self, *args) -> None:
        print(*args)

    def add_progress_listener(self, listener) -> None:
        if listener not in self.progress_listeners:
            self.progress_listeners.append(listener)

    def _progress(self, increment: int) -> None:
        self._frames_done += increment
        if self.frame_count:
            self.progress_total = int(100 * self._frames_done / self.frame_count)
        for listener in self.progress_listeners:
            try:
                listener(self.progress_total, self.is_finished)
            except Exception:
                pass

    # ---- lazy components ----
    def _ckpt(self, name: str) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        return os.path.join(self.checkpoint_dir, name)

    @property
    def sttn_auto_inpaint(self):
        if self._sttn_auto is None:
            from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter

            self._sttn_auto = STTNAutoInpainter(
                checkpoint_path=self._ckpt("sttn_auto.npz"), config=self.config,
                device=self.requested_device)
        return self._sttn_auto

    @property
    def sttn_det_inpaint(self):
        if self._sttn_det is None:
            from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter

            self._sttn_det = STTNDetInpainter(
                checkpoint_path=self._ckpt("sttn_det.npz"), config=self.config,
                device=self.requested_device)
        return self._sttn_det

    @property
    def lama_inpaint(self):
        if self._lama is None:
            from vsr_tpu_torch.inpaint.lama import LamaInpainter

            self._lama = LamaInpainter(
                checkpoint_path=self._ckpt("lama.npz"), config=self.config,
                device=self.device)
        return self._lama

    @property
    def propainter_inpaint(self):
        if self._propainter is None:
            from vsr_tpu_torch.inpaint.propainter import PropainterInpainter

            self._propainter = PropainterInpainter(
                checkpoint_dir=self.checkpoint_dir or None, config=self.config,
                device=self.device)
        return self._propainter

    @property
    def detector(self):
        if self._detector is None:
            from vsr_tpu_torch.detect.detector import SubtitleDetector

            self._detector = SubtitleDetector(
                self.video_path, sub_areas=self.sub_areas, config=self.config,
                checkpoint_path=self._ckpt("dbnet.npz"), device=self.device)
        return self._detector

    # ---- modes ----
    def _sttn_auto_mode(self, writer) -> None:
        """Fixed-area temporal inpaint, no detection (ref main.py:247-258)."""
        self.append_output(tr.text("Main", "ProcessingStartRemovingSubtitles"))
        coords = [(xmin, xmax, ymin, ymax) for ymin, ymax, xmin, xmax in self.sub_areas]
        mask = create_mask(
            self.mask_size, coords, self.config.subtitle_area_deviation_pixel
        )
        reader = FramePrefetcher(VideoReader(self.video_path))
        try:
            self.sttn_auto_inpaint.process_video(
                reader,
                writer,
                mask,
                frame_count=self.frame_count,
                size=self.size,
                ab_sections=self.ab_sections,
                progress_cb=self._progress,
                preview_cb=self.preview_cb,
            )
        finally:
            reader.release()

    def _preview(self, original: np.ndarray, mask: Optional[np.ndarray],
                 inpainted: np.ndarray) -> None:
        """Emit a (mask-highlighted original, inpainted) preview pair, the
        reference's update_preview_with_comp payload (main.py:244,331)."""
        if self.preview_cb is None:
            return
        if mask is not None:
            original = np.clip(
                original + mask[:, :, np.newaxis] * 0.3, 0, 255
            ).astype(np.uint8)
        try:
            self.preview_cb(original, inpainted)
        except Exception:
            pass

    def _video_inpaint_mode(self, writer, model) -> None:
        """Detection-driven batch inpaint (ref main.py:260-333)."""
        self.append_output(tr.text("Main", "ProcessingStartFindingSubtitles"))
        sub_list = self.detector.find_subtitle_frame_no(sub_remover=self)
        self.append_output(tr.text("Main", "FinishedFindingSubtitles"))
        if not sub_list:
            raise RuntimeError(
                tr.text("Main", "NoSubtitleDetected", self.video_path))
        ranges = find_continuous_ranges_with_same_mask(sub_list)
        ranges = expand_frame_ranges(
            ranges,
            self.config.subtitle_timeline_backward_frame_count,
            self.config.subtitle_timeline_forward_frame_count,
        )
        ranges = filter_and_merge_intervals(
            ranges, self.config.sttn_reference_length
        )
        start_end = {s: min(e, self.frame_count) for s, e in ranges}

        self.append_output(tr.text("Main", "ProcessingStartRemovingSubtitles"))
        reader = FramePrefetcher(VideoReader(self.video_path))
        try:
            index = 0
            while True:
                ok, frame = reader.read()
                if not ok:
                    break
                index += 1
                if index not in start_end:
                    writer.write(frame)
                    self._progress(1)
                    self._preview(frame, None, frame)
                    continue
                end_index = start_end[index]
                frames = [frame]
                while index < end_index:
                    ok, frame = reader.read()
                    if not ok:
                        break
                    index += 1
                    frames.append(frame)
                # union of detected boxes over the range, dropping
                # taller-than-wide false positives (ref main.py:309-319)
                coords = self._collect_mask_coords(
                    sub_list, index - len(frames) + 1, end_index
                )
                mask = create_mask(
                    self.mask_size, coords, self.config.subtitle_area_deviation_pixel
                )
                for batch in batch_generator(frames, self.config.get_sttn_max_load_num()):
                    inpainted = model(list(batch), mask)
                    for src, out_frame in zip(batch, inpainted):
                        writer.write(out_frame)
                        self._preview(src, mask, out_frame)
                    self._progress(len(batch))
        finally:
            reader.release()

    def _collect_mask_coords(self, sub_list, start: int, end: int):
        coords = []
        for i in range(start, end):
            if i in sub_list:
                for area in sub_list[i]:
                    xmin, xmax, ymin, ymax = area
                    if (ymax - ymin) - (xmax - xmin) > self.config.subtitle_yx_axis_difference_pixel:
                        continue
                    if area not in coords:
                        coords.append(area)
        return coords

    def _propainter_mode(self, writer) -> None:
        """Detection, scene split and ProPainter batches (ref main.py:159-245):
        each run of frames that share one box set, cut at scene changes, goes
        to ProPainter in batches of propainter_max_load_num; a single frame
        (a run's or a batch's) goes to LaMa."""
        from vsr_tpu_torch.scenes.content import get_scene_div_frame_no

        self.append_output(tr.text("Main", "ProcessingStartFindingSubtitles"))
        sub_list = self.detector.find_subtitle_frame_no(sub_remover=self)
        self.append_output(tr.text("Main", "FinishedFindingSubtitles"))
        if not sub_list:
            raise RuntimeError(
                tr.text("Main", "NoSubtitleDetected", self.video_path))
        ranges = find_continuous_ranges_with_same_mask(sub_list)
        ranges = split_range_by_scene(ranges, get_scene_div_frame_no(self.video_path))

        reader = FramePrefetcher(VideoReader(self.video_path))
        try:
            index = 0
            while True:
                ok, frame = reader.read()
                if not ok:
                    break
                index += 1
                if index not in sub_list:
                    writer.write(frame)
                    self._progress(1)
                    continue
                end_no = next((e for s, e in ranges if s <= index <= e), index)
                frames = [frame]
                while index < end_no:
                    ok, frame = reader.read()
                    if not ok:
                        break
                    index += 1
                    frames.append(frame)
                # collection starts on a detected frame and ranges are runs of
                # consecutive keys, so the start is a key: index it directly
                # (ref main.py:229) and let a timeline bug raise
                mask = create_mask(self.mask_size, sub_list[index - len(frames) + 1],
                                   self.config.subtitle_area_deviation_pixel)
                for batch in batch_generator(frames, self.config.propainter_max_load_num):
                    if len(batch) == 1:
                        outs = [self.lama_inpaint.inpaint(batch[0], mask)]
                    else:
                        outs = self.propainter_inpaint(list(batch), mask)
                    for src, out_frame in zip(batch, outs):
                        writer.write(out_frame)
                        self._preview(src, mask, out_frame)
                    self._progress(len(batch))
        finally:
            reader.release()

    def _run_picture(self) -> None:
        """Single-image removal via detection + LaMa (ref main.py:353-371):
        the whole model output is written, as the reference does."""
        original = cv2.imread(self.video_path)
        boxes = self.detector.detect_subtitle(original)
        if boxes:
            mask = create_mask(
                original.shape[:2], boxes, self.config.subtitle_area_deviation_pixel
            )
            out = self.lama_inpaint.inpaint(original, mask)
        else:
            out = original
        os.makedirs(os.path.dirname(self.video_out_path) or ".", exist_ok=True)
        if not cv2.imwrite(self.video_out_path, out):
            raise IOError(f"cannot write image: {self.video_out_path}")
        self._progress(1)

    # ---- main entry ----
    def run(self) -> None:
        mode = self.config.inpaint_mode
        start_time = time.time()
        if not self.sub_areas:
            self.append_output(tr.text("Main", "FullScreenProcessingNote"))
            self.sub_areas.append((0, self.frame_height, 0, self.frame_width))
        os.makedirs(os.path.dirname(self.video_out_path) or ".", exist_ok=True)

        # log_model parity (ref main.py:403,462-470)
        self.append_output(tr.text(
            "Main", "SubtitleRemoverModel",
            tr.text("InpaintMode", mode.name)))
        if mode != InpaintMode.STTN_AUTO or self.is_picture:
            self.append_output(tr.text(
                "Main", "SubtitleDetectionModel",
                tr.text("SubtitleDetectMode", self.config.subtitle_detect_mode.name)))

        if self.is_picture:
            self._run_picture()
        else:
            self._run_video(mode)

        self.is_finished = True
        self.progress_total = 100
        self.append_output(tr.text("Main", "FinishedProcessing",
                                   self.video_out_path))
        self.append_output(tr.text("Main", "ProcessingTime",
                                   round(time.time() - start_time, 1)))

    def _run_video(self, mode: InpaintMode) -> None:
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        tmp.close()
        writer = VideoWriter(
            tmp.name, self.fps, self.size,
            crf=self.config.encode_crf, preset=self.config.encode_preset,
        )
        try:
            if mode == InpaintMode.STTN_AUTO:
                self._sttn_auto_mode(writer)
            elif mode == InpaintMode.STTN_DET:
                self._video_inpaint_mode(writer, self.sttn_det_inpaint)
            elif mode == InpaintMode.LAMA:
                self._video_inpaint_mode(writer, self.lama_inpaint)
            elif mode == InpaintMode.PROPAINTER:
                self._propainter_mode(writer)
            elif mode == InpaintMode.OPENCV:
                from vsr_tpu_torch.inpaint.opencv import OpenCVInpainter

                self._video_inpaint_mode(writer, OpenCVInpainter())
            else:
                raise ValueError(f"inpaint mode not implemented: {mode}")
        except BaseException:
            # best-effort close; don't mask the original failure with an
            # encoder-death error from release()
            try:
                writer.release()
            except Exception:
                pass
            raise
        else:
            writer.release()
        self.is_successful_merged = merge_audio_to_video(
            self.video_path, tmp.name, self.video_out_path,
            log=self.append_output,
        )
        try:
            os.remove(tmp.name)
        except OSError:
            pass
