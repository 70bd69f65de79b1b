"""User-facing string catalog with locale support (copy of
``vsr_tpu/i18n.py``, with its own copy of the locale files).

Replaces the reference's configparser .ini i18n (backend/config.py:123-126,
backend/interface/*.ini). Strings live in-code as the English catalog;
additional locales load from ini files in VSR_TPU_LOCALE_DIR with the same
section/key layout, falling back to English per key.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, Optional

_EN: Dict[str, Dict[str, str]] = {
    "Main": {
        "FullScreenProcessingNote": "processing full frame (no subtitle area given)",
        "SubtitleArea": "subtitle areas: {}",
        "ABSection": "AB sections: {}",
        "ABSectionAll": "all frames",
        "ProcessingStartFindingSubtitles": "detecting subtitles...",
        "FinishedFindingSubtitles": "subtitle detection finished",
        "ProcessingStartRemovingSubtitles": "removing subtitles...",
        "NoSubtitleDetected": "no subtitles detected in {}",
        "FinishedProcessing": "finished: {}",
        "ProcessingTime": "processing time: {}s",
        "FailToExtractAudio": "failed to extract audio: {}",
        "FailToMergeAudio": "failed to merge audio: {}",
        "FFmpegMissingNote": "ffmpeg not found; writing video without audio",
        "CopyFileFailed": "failed to copy {} to {}: {}",
        "ReadImageFailed": "failed to read image: {}",
        "SubtitleRemoverModel": "inpaint model: {}",
        "SubtitleDetectionModel": "detection model: {}",
    },
    "InpaintMode": {
        "STTN_AUTO": "STTN (auto)",
        "STTN_DET": "STTN (detection)",
        "LAMA": "LaMa",
        "PROPAINTER": "ProPainter",
        "OPENCV": "OpenCV",
    },
    "SubtitleDetectMode": {
        "PP_OCRv5_MOBILE": "fast (mobile)",
        "PP_OCRv5_SERVER": "precise (server)",
    },
    # browser GUI labels (served via /api/i18n; ref keys every GUI string
    # through tr the same way, backend/config.py:123-126)
    "GUI": {
        "Tasks": "Tasks",
        "Add": "Add",
        "Run": "Run",
        "Stop": "Stop",
        "Settings": "Settings",
        "SaveAreas": "Save subtitle areas",
        "ClearAreas": "Clear areas",
        "ClearAB": "A/B ✕",
        "Hint": "drag on frame: new area · drag inside: move · "
                "corner: resize · double-click: delete · "
                "areas save per task",
        "PathPlaceholder": "/path/to/video.mp4",
        "Frame": "frame",
        "LivePreview": "live preview",
    },
}


class Translator:
    def __init__(self, locale: str = "en", locale_dir: Optional[str] = None):
        self.locale = locale
        self._catalog = {k: dict(v) for k, v in _EN.items()}
        locale_dir = locale_dir or os.environ.get(
            "VSR_TPU_LOCALE_DIR",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "locales"))
        if locale != "en" and locale_dir:
            path = os.path.join(locale_dir, f"{locale}.ini")
            if os.path.exists(path):
                parser = configparser.ConfigParser()
                parser.optionxform = str  # preserve key case
                parser.read(path, encoding="utf-8")
                for section in parser.sections():
                    self._catalog.setdefault(section, {}).update(
                        dict(parser[section]))

    def __getitem__(self, section: str) -> Dict[str, str]:
        return self._catalog.get(section, {})

    def text(self, section: str, key: str, *args) -> str:
        template = self._catalog.get(section, {}).get(
            key, _EN.get(section, {}).get(key, key))
        return template.format(*args) if args else template


tr = Translator()


def set_locale(locale: str, locale_dir: Optional[str] = None) -> Translator:
    """Swap the process-wide catalog (ref keys tr off config.interface,
    backend/config.py:123-126). Mutates the shared ``tr`` in place so
    modules holding ``from vsr_tpu_torch.i18n import tr`` see the change."""
    fresh = Translator(locale, locale_dir)
    tr.locale = fresh.locale
    tr._catalog = fresh._catalog
    return tr


def available_locales(locale_dir: Optional[str] = None) -> list:
    locale_dir = locale_dir or os.environ.get(
        "VSR_TPU_LOCALE_DIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "locales"))
    names = {"en"}
    if os.path.isdir(locale_dir):
        for fn in os.listdir(locale_dir):
            if fn.endswith(".ini"):
                names.add(fn[:-4])
    return sorted(names)
