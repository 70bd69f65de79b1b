"""Pipeline orchestrator on the port: ``vsr_tpu.pipeline.SubtitleRemover``
with its sttn-auto inpainter built from ``vsr_tpu_torch`` on an explicit
device. The modes that are not ported yet raise."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from vsr_tpu.config import Config, InpaintMode
from vsr_tpu.pipeline import SubtitleRemover as _SubtitleRemover
from vsr_tpu_torch.utils.device import resolve_device

# ROADMAP.md Queue 1 item that ports each mode still missing (opencv mode
# waits for detection, picture mode for detection and LaMa).
UNPORTED_MODES = {
    InpaintMode.STTN_DET: "5",
    InpaintMode.OPENCV: "6",
    InpaintMode.LAMA: "7",
    InpaintMode.PROPAINTER: "8",
}


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to vsr_tpu_torch yet (ROADMAP.md Queue 1 item {item})")


class SubtitleRemover(_SubtitleRemover):
    def __init__(
        self,
        video_path: str,
        output_path: Optional[str] = None,
        sub_areas: Optional[Sequence[Tuple[int, int, int, int]]] = None,
        config: Optional[Config] = None,
        checkpoint_dir: Optional[str] = None,
        gui_mode: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        super().__init__(video_path, output_path=output_path, sub_areas=sub_areas,
                         config=config, checkpoint_dir=checkpoint_dir,
                         gui_mode=gui_mode)

    def run(self) -> None:
        mode = self.config.inpaint_mode
        if self.is_picture:
            _not_ported("picture mode", "6 and 7")
        if mode in UNPORTED_MODES:
            _not_ported(f"inpaint mode {mode.value}", UNPORTED_MODES[mode])
        super().run()

    @property
    def sttn_auto_inpaint(self):
        if self._sttn_auto is None:
            from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter

            self._sttn_auto = STTNAutoInpainter(
                checkpoint_path=self._ckpt("sttn_auto.npz"), config=self.config,
                device=self.device)
        return self._sttn_auto

    @property
    def sttn_det_inpaint(self):
        _not_ported("sttn-det inpainting", "5")

    @property
    def lama_inpaint(self):
        _not_ported("LaMa inpainting", "7")

    @property
    def propainter_inpaint(self):
        _not_ported("ProPainter inpainting", "8")

    @property
    def detector(self):
        _not_ported("subtitle detection", "6")
