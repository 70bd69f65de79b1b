"""sttn-det through the port's entry, ``STTNDetInpainter.__call__``, driven
by the frame loop of ``pipeline.py:_video_inpaint_mode`` (mirrored here,
about thirty lines): the traffic's frame -> boxes map stands in for
``SubtitleDetector.find_subtitle_frame_no``; ranges, masks and batches come
from the port's own ``find_continuous_ranges_with_same_mask``,
``expand_frame_ranges``, ``filter_and_merge_intervals``, ``create_mask`` and
``batch_generator``; frames outside every range pass straight through.

A range begun before the deadline is finished: the reader stops handing
out frames only between ranges, so every batch has a length the traffic
makes and the warm-up ran."""

from __future__ import annotations

import torch

from perfbench import generator
from perfbench.drivers.sttn_auto import (  # noqa: F401 (install_control: the control)
    STTNFamily,
    common_spans,
    install_control,
    kernel_launches,
    load_program,
)
from perfbench.reference import pipeline as ref
from perfbench.weights import make_netg


def schedule_lengths(start_end, max_load: int):
    """The batch lengths the loop will hand the program."""
    from vsr_tpu_torch.masks.intervals import batch_generator

    return sorted({len(b) for s, e in start_end.items()
                   for b in batch_generator(range(s, e + 1), max_load)}, reverse=True)


class Driver(STTNFamily):
    unit_of = None  # units are batches, named by the loop (Writer.begin_unit)

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter
        from vsr_tpu_torch.masks.intervals import (
            expand_frame_ranges,
            filter_and_merge_intervals,
            find_continuous_ranges_with_same_mask,
        )

        self.cfg, self.mix, self.device = cfg, mix, device
        self.frame_shape = (mix["height"], mix["width"], 3)
        self.pool = generator.frame_pool(mix, seed, device)
        self.netg = make_netg(cfg, seed, device)
        self.program = load_program(STTNDetInpainter, cfg, mix, self.netg, seed, device)
        self.config = self.program.config
        lines = generator.timeline_lines(mix, seed, mix["horizon_frames"])
        self.sub_list = generator.boxes_by_frame(lines)
        ranges = find_continuous_ranges_with_same_mask(self.sub_list)
        ranges = expand_frame_ranges(ranges, self.config.subtitle_timeline_backward_frame_count,
                                     self.config.subtitle_timeline_forward_frame_count)
        ranges = filter_and_merge_intervals(ranges, self.config.sttn_reference_length)
        self.start_end = {s: e for s, e in ranges}
        self.first_boxes = lines[0][2]
        self._launches = 0

    def _collect_mask_coords(self, start: int, end: int):
        """pipeline.SubtitleRemover._collect_mask_coords."""
        coords = []
        for i in range(start, end):
            for area in self.sub_list.get(i, ()):
                xmin, xmax, ymin, ymax = area
                if (ymax - ymin) - (xmax - xmin) > self.config.subtitle_yx_axis_difference_pixel:
                    continue
                if area not in coords:
                    coords.append(area)
        return coords

    def warm(self) -> None:
        """One batch of every length the traffic's ranges make."""
        from vsr_tpu_torch.masks.mask import create_mask

        mask = create_mask(self.frame_shape[:2], self.first_boxes,
                           self.config.subtitle_area_deviation_pixel)
        for n in schedule_lengths(self.start_end, self.config.get_sttn_max_load_num()):
            self.program([self.pool[i % len(self.pool)] for i in range(n)], mask)

    def window(self, reader, writer):
        """The loop of pipeline._video_inpaint_mode over the reader."""
        from vsr_tpu_torch.masks.intervals import batch_generator
        from vsr_tpu_torch.masks.mask import create_mask

        start = kernel_launches()
        work = []
        index = 0
        while not reader.expired():
            frame = reader.take()
            index += 1
            if index not in self.start_end:
                writer.begin_unit(None)
                writer.write(frame)
                continue
            end_index = self.start_end[index]
            frames = [frame]
            while index < end_index:
                frames.append(reader.take())
                index += 1
            coords = self._collect_mask_coords(index - len(frames) + 1, end_index)
            mask = create_mask(self.frame_shape[:2], coords,
                               self.config.subtitle_area_deviation_pixel)
            first = index - len(frames)
            for batch in batch_generator(frames, self.config.get_sttn_max_load_num()):
                out = self.program(list(batch), mask)
                writer.begin_unit(first)
                for f in out:
                    writer.write(f)
                clip = min(self.config.get_sttn_max_load_num(),
                           max(len(batch), self.config.sttn_reference_length))
                work.append((len(batch), clip, mask))
                first += len(batch)
        self._launches = kernel_launches() - start
        return work

    def launches(self) -> int:
        return self._launches

    def host_spans(self):
        from vsr_tpu_torch.inpaint import sttn_det

        return common_spans() + [
            (sttn_det.STTNDetInpainter, "__call__", "sttn_det.__call__", None),
            (sttn_det, "paste_band", "paste_band", None)]

    def free(self) -> None:
        self.program = None

    def chunk_work(self, raw):
        """(frames, chunk length, bands) of each batch the window ran."""
        from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

        H, W = self.frame_shape[:2]
        num, den = self.cfg["band_height_of_height"] if H > W else self.cfg["band_height_of_width"]
        split = (H if H > W else W) * num // den
        bands = {}
        for _, _, mask in raw:
            if id(mask) not in bands:
                bands[id(mask)] = len(get_inpaint_area_by_mask(W, H, split, mask))
        return [(n, clip, bands[id(mask)]) for n, clip, mask in raw]

    @staticmethod
    def reference_unit(cfg, mix, seed, pool, model, first, length, taken, device):
        """The reference's batch that starts at stream frame ``first`` (frame
        number first + 1), or None where its schedule has no batch of that
        length there."""
        boxes = generator.boxes_by_frame(
            generator.timeline_lines(mix, seed, mix["horizon_frames"]))
        for s, e, coords in ref.det_schedule(boxes, taken, cfg):
            if s == first + 1:
                if e - s + 1 != length:
                    return None
                mask = ref.rasterize((mix["height"], mix["width"]), coords, mix["dilation"])
                frames = [pool[(f - 1) % len(pool)] for f in range(s, e + 1)]
                with torch.no_grad():
                    return ref.sttn_det(model, frames, mask, cfg, device), mask
        return None
