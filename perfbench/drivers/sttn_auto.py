"""sttn-auto through the port's streaming entry,
``STTNAutoInpainter.process_video``, as ``pipeline.py:_sttn_auto_mode``
drives it: one mask from the selection area, frames read from the
benchmark's reader, written to its writer. The program's settings are the
configuration's."""

from __future__ import annotations

import os
import tempfile

import torch

from perfbench import counts, generator
from perfbench.reference import pipeline as ref
from perfbench.weights import make_netg, reference_model, write_checkpoint

LAST_FRAME = 1 << 62  # process_video's frame_count: the reader ends the stream


def program_config(cfg: dict, mix: dict):
    from vsr_tpu_torch.config import Config

    return Config(compute_dtype=cfg["dtype"], sttn_neighbor_stride=cfg["neighbor_stride"],
                  sttn_reference_length=cfg["ref_length"], sttn_max_load_num=cfg["chunk_frames"],
                  subtitle_area_deviation_pixel=mix["dilation"])


def check_model(model, cfg: dict) -> None:
    """The port's generator has the configuration's widths and depth."""
    if (len(model.transformer) != cfg["blocks"]
            or model.encoder[6].out_channels != cfg["channel"]
            or [list(p) for p in model.patchsizes] != cfg["patch_sizes"]):
        raise ValueError(f"the program's STTN is not the configuration {cfg['name']}")


def load_program(cls, cfg: dict, mix: dict, netg: dict, seed: int, device):
    """The inpainter ``cls`` on the weights ``netg``, loaded from a
    published-layout checkpoint file under TMPDIR."""
    path = write_checkpoint(netg, tempfile.gettempdir(), seed)
    try:
        program = cls(checkpoint_path=path, config=program_config(cfg, mix), device=device)
    finally:
        os.remove(path)
    check_model(program.model, cfg)
    return program


def attention_call(q, k, v, key_bias=None):
    """(B, Nq, Nk, D, itemsize, bias) of one token-attention call."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.element_size(),
            key_bias is not None)


def common_spans():
    """The program's host steps both STTN modes share, and the kernel's calls."""
    from vsr_tpu_torch.inpaint.engine import STTNWindowEngine
    from vsr_tpu_torch.ops import patch_attention

    return [(STTNWindowEngine, "dispatch", "engine.dispatch", None),
            (STTNWindowEngine, "fetch", "engine.fetch", None),
            (patch_attention, "flash_token_attention", None, attention_call)]


def kernel_launches() -> int:
    from vsr_tpu_torch.ops import token_attention

    return token_attention.launches


class ReferenceProgram:
    """The plain reference in the program's place (the control): the same
    entry points, computing ``ref.sttn_auto`` / ``ref.sttn_det`` with
    ``model`` chunk by chunk."""

    def __init__(self, model, cfg: dict, device):
        self.model, self.cfg, self.device = model, cfg, device

    def process_video(self, reader, writer, mask, frame_count, size):
        chunk, n = [], 0
        while True:
            ok, frame = reader.read() if n < frame_count else (False, None)
            if ok:
                chunk.append(frame)
                n += 1
            if chunk and (not ok or len(chunk) == self.cfg["chunk_frames"]):
                out = ref.sttn_auto(self.model, chunk, mask, self.cfg, self.device)
                for frame in out.cpu().numpy():
                    writer.write(frame)
                chunk = []
            if not ok:
                return n

    def __call__(self, frames, mask):
        return list(ref.sttn_det(self.model, frames, mask, self.cfg, self.device).cpu().numpy())


def install_control(driver, quant: str = "fp8_e4m3") -> None:
    """Puts the reference computed in ``quant`` in the driver's program's
    place, on the same seeded weights."""
    model = driver.reference_model(driver.cfg, quant).to(driver.device).eval()
    model.load_state_dict(driver.netg, strict=True)
    driver.program = ReferenceProgram(model, driver.cfg, driver.device)


class STTNFamily:
    """What the harness asks of a driver about its model family, for both
    STTN modes: the plain reference (``reference/sttn.py``), the
    token-attention kernel's launches and the model FLOPs (``counts.py``)."""

    @staticmethod
    def reference_model(cfg: dict, quant: str = "float32"):
        return reference_model(cfg, quant)

    @staticmethod
    def expected_launches(cfg: dict, work) -> int:
        return counts.token_attention_launches(work, cfg)

    @staticmethod
    def model_flops(cfg: dict, work) -> int:
        return sum(bands * counts.chunk_flops(frames, cfg) for frames, _, bands in work)


class Driver(STTNFamily):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
        from vsr_tpu_torch.masks.mask import create_mask
        from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

        self.cfg, self.mix, self.device = cfg, mix, device
        self.frame_shape = (mix["height"], mix["width"], 3)
        self.pool = generator.frame_pool(mix, seed, device)
        self.netg = make_netg(cfg, seed, device)
        self.program = load_program(STTNAutoInpainter, cfg, mix, self.netg, seed, device)
        self.mask = create_mask(self.frame_shape[:2], [generator.selection_box(mix)],
                                mix["dilation"])
        W = mix["width"]
        num, den = cfg["band_height_of_width"]
        self.bands = len(get_inpaint_area_by_mask(W, mix["height"], W * num // den, self.mask))
        self.chunk = cfg["chunk_frames"]

    def unit_of(self, index: int) -> int:
        return index // self.chunk

    def _run(self, reader, writer) -> int:
        size = (self.mix["width"], self.mix["height"])
        return self.program.process_video(reader, writer, self.mask, LAST_FRAME, size)

    def warm(self) -> None:
        """Three chunks: the one shape the cell uses, with two in flight."""
        from perfbench.harness import Reader

        class Sink:
            def write(self, frame):
                pass

        self._run(Reader(self.pool, limit=3 * self.chunk), Sink())

    def window(self, reader, writer):
        start = kernel_launches()
        self._run(reader, writer)
        self._launches = kernel_launches() - start
        return reader.taken

    def chunk_work(self, taken: int):
        """(frames, chunk length, bands) of each chunk the window ran."""
        return [(min(self.chunk, taken - s), self.chunk, self.bands)
                for s in range(0, taken, self.chunk)]

    def launches(self) -> int:
        return self._launches

    def host_spans(self):
        from vsr_tpu_torch.inpaint import sttn_auto

        return common_spans() + [
            (sttn_auto.STTNAutoInpainter, "_stack_band", "crop_resize", None),
            (sttn_auto, "paste_band", "paste_band", None)]

    def free(self) -> None:
        self.program = None

    @staticmethod
    def reference_unit(cfg, mix, seed, pool, model, first, length, taken, device):
        """The reference's chunk starting at stream frame ``first``, or None
        where its chunks do not start there or have another length."""
        chunk = cfg["chunk_frames"]
        if first % chunk or length != min(chunk, taken - first):
            return None
        mask = ref.rasterize((mix["height"], mix["width"]), [generator.selection_box(mix)],
                             mix["dilation"])
        frames = [pool[i % len(pool)] for i in range(first, first + length)]
        with torch.no_grad():
            return ref.sttn_auto(model, frames, mask, cfg, device), mask
