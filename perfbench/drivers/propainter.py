"""ProPainter through the port's entry, ``PropainterInpainter.__call__``,
driven by the frame loop of ``pipeline.py:_propainter_mode`` (mirrored
here, a few lines, as ``drivers/sttn_det.py`` mirrors its mode's loop):
the traffic's selection box stands in for ``find_subtitle_frame_no``, so
every frame of the stream is one run of frames under one box set, under
the mask of the port's ``create_mask`` (dilated by the traffic's
``dilation``). The run is handed to the inpainter in clips of
``propainter_max_load_num`` frames: the batches the mode's
``batch_generator`` forms from a run of 70 k + r frames with r >= 35 (it
lowers the size for other lengths, to 46 + 24 for a run of 70). A clip
begun before the deadline is finished: the reader stops handing out
frames only between clips. The scene split and the LaMa single-frame
fallback of that mode are bypassed: the stream has no scene cut, and no
clip holds one frame.

The program is built as a deployment builds it: the seeded weights are
written as the three published checkpoints (``weights_propainter.py``),
converted by the port's ``prepare_models`` (``--prepare-models``) and
loaded by the inpainter from the converted directory, all under TMPDIR and
deleted once loaded."""

from __future__ import annotations

import os
import tempfile

from perfbench import counts_propainter, generator, pp_spans
from perfbench.reference import pipeline as ref_pipeline
from perfbench.reference import propainter as ref
from perfbench.weights_propainter import make_weights, reference_model, write_checkpoints

FAMILIES = ("raft", "flow-completion", "propainter")


def program_config(cfg: dict, mix: dict):
    from vsr_tpu_torch.config import Config

    return Config(compute_dtype=cfg["dtype"], propainter_max_load_num=cfg["clip_frames"],
                  propainter_neighbor_length=cfg["neighbor_length"],
                  propainter_ref_stride=cfg["ref_stride"],
                  propainter_subvideo_length=cfg["subvideo_length"],
                  propainter_raft_iters=cfg["raft"]["iters"],
                  subtitle_area_deviation_pixel=mix["dilation"])


def network_kwargs(cfg: dict):
    """The inpainter's (generator_kwargs, raft_kwargs) of the configuration."""
    g, r = cfg["generator"], cfg["raft"]
    return (dict(channel=g["channel"], hidden=g["hidden"], depths=g["depths"], n_head=g["heads"],
                 window_size=tuple(g["window_size"]), pool_size=tuple(g["pool_size"])),
            dict(hidden=r["hidden"], context=r["context"], corr_levels=r["corr_levels"],
                 corr_radius=r["corr_radius"]))


def check_program(program, cfg: dict) -> None:
    """The port's networks have the configuration's widths, depth and
    schedule."""
    g, r, gen, raft = cfg["generator"], cfg["raft"], program.generator, program.raft
    attention = gen.block0.attention
    ok = (gen.channel == g["channel"] and gen.hidden == g["hidden"]
          and gen.depths == g["depths"] and attention.n_head == g["heads"]
          and list(gen.window_size) == g["window_size"]
          and list(attention.pool_size) == g["pool_size"]
          and raft.hidden == r["hidden"] and raft.corr_levels == r["corr_levels"]
          and raft.corr_radius == r["corr_radius"] and raft.iters == r["iters"]
          and program.mask_dilation == cfg["mask_dilation"])
    if not ok:
        raise ValueError(f"the program's ProPainter is not the configuration {cfg['name']}")


def load_program(cfg: dict, mix: dict, netg: dict, device):
    """The inpainter on the weights ``netg``, through the published
    checkpoint files and the port's converter."""
    from vsr_tpu_torch.inpaint.propainter import PropainterInpainter
    from vsr_tpu_torch.prepare import prepare_models

    gen_kw, raft_kw = network_kwargs(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "models")
        os.makedirs(os.path.join(src, "propainter"))
        write_checkpoints(netg, os.path.join(src, "propainter"))
        out = os.path.join(tmp, "npz")
        status = prepare_models(src, out, families=list(FAMILIES), log=lambda _: None,
                                check_fn=lambda *_: None)
        if set(status.values()) != {"converted"}:
            raise RuntimeError(f"converting the seeded checkpoints: {status}")
        program = PropainterInpainter(out, program_config(cfg, mix), gen_kw, raft_kw,
                                      device=device)
    check_program(program, cfg)
    return program


def kernel_launches() -> int:
    from vsr_tpu_torch.ops import token_attention

    return token_attention.launches


def clip_reference(model, frames, mask, cfg, device):
    return ref.propainter(model, frames, mask, cfg, device)


class ReferenceProgram:
    """The plain reference in the program's place (the control)."""

    def __init__(self, model, cfg: dict, device):
        self.model, self.cfg, self.device = model, cfg, device

    def __call__(self, frames, mask):
        return list(clip_reference(self.model, frames, mask, self.cfg, self.device)[0]
                    .cpu().numpy())


def install_control(driver, quant: str = "fp8_e4m3") -> None:
    """Puts the reference computed in ``quant`` in the driver's program's
    place, on the same seeded weights."""
    model = driver.reference_model(driver.cfg, quant).to(driver.device).eval()
    model.load_state_dict(driver.netg, strict=True)
    driver.program = ReferenceProgram(model, driver.cfg, driver.device)


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from vsr_tpu_torch.masks.mask import create_mask
        from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

        self.cfg, self.mix, self.device = cfg, mix, device
        self.frame_shape = (mix["height"], mix["width"], 3)
        self.pool = generator.frame_pool(mix, seed, device)
        self.netg = make_weights(cfg, seed, device)
        self.program = load_program(cfg, mix, self.netg, device)
        self.config = self.program.config
        H, W = self.frame_shape[:2]
        self.mask = create_mask((H, W), [generator.selection_box(mix)],
                                self.config.subtitle_area_deviation_pixel)
        num, den = cfg["band_height_of_width"]
        self.bands = [(ymax - ymin, xmax - xmin) for ymin, ymax, xmin, xmax in
                      get_inpaint_area_by_mask(W, H, W * num // den, self.mask[:, :, None],
                                               multiple=8)]
        self.clip = self.config.propainter_max_load_num
        self._launches = 0

    def unit_of(self, index: int) -> int:
        return index // self.clip

    def warm(self) -> None:
        """One clip: the one shape the cell uses."""
        self.program([f.copy() for f in self.pool[:self.clip]], self.mask)

    def window(self, reader, writer):
        """The loop of pipeline._propainter_mode over the reader, one run of
        frames under one box set in clips; returns the frames taken."""
        start = kernel_launches()
        pp_spans.reset()
        while not reader.expired():
            out = self.program([reader.take() for _ in range(self.clip)], self.mask)
            pp_spans.collect()
            for f in out:
                writer.write(f)
        self._launches = kernel_launches() - start
        return reader.taken

    def chunk_work(self, taken: int):
        """(frames, band height, band width) of each band of each clip."""
        return [(self.clip, bh, bw) for _ in range(taken // self.clip) for bh, bw in self.bands]

    def launches(self) -> int:
        return self._launches

    def host_spans(self):
        from vsr_tpu_torch.inpaint.propainter import PropainterInpainter

        return [(PropainterInpainter, "__call__", "propainter.__call__", None)]

    def free(self) -> None:
        self.program = None

    @staticmethod
    def reference_unit(cfg, mix, seed, pool, model, first, length, taken, device):
        """The reference's clip starting at stream frame ``first``, or None
        where its clips do not start there or have another length."""
        clip = cfg["clip_frames"]
        if first % clip or length != clip:
            return None
        mask = ref_pipeline.rasterize((mix["height"], mix["width"]),
                                      [generator.selection_box(mix)], mix["dilation"])
        frames = [pool[i % len(pool)] for i in range(first, first + length)]
        out, region = clip_reference(model, frames, mask, cfg, device)
        return out, region.astype("uint8")

    @staticmethod
    def reference_model(cfg: dict, quant: str = "float32"):
        return reference_model(cfg, quant)

    @staticmethod
    def expected_launches(cfg: dict, work) -> int:
        """ProPainter runs no hand-written kernel."""
        return 0

    @staticmethod
    def model_flops(cfg: dict, work) -> int:
        return counts_propainter.model_flops(cfg, work)
