"""Release update check (parity with backend/tools/version_service.py:12-60);
a copy of ``vsr_tpu/utils/version_service.py``.

Polls the project's releases API with a mirror fallback; network failures and
air-gapped environments degrade to "no update information". Proxy settings
are taken from the standard environment variables.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional, Tuple

from vsr_tpu_torch.version import __version__

UPDATE_URLS = [
    "https://api.github.com/repos/YaoFANGUK/video-subtitle-remover/releases/latest",
    "https://accelerate.xdow.net/api/repos/YaoFANGUK/video-subtitle-remover/releases/latest",
]


def _parse_version(tag: str) -> Tuple[int, ...]:
    return tuple(int(p) for p in tag.lstrip("v").split(".") if p.isdigit())


def check_latest_release(timeout: float = 5.0) -> Optional[dict]:
    """Return {'tag': str, 'url': str, 'newer': bool} or None if unreachable."""
    for url in UPDATE_URLS:
        try:
            req = urllib.request.Request(
                url, headers={"User-Agent": "vsr-tpu-version-check"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = json.loads(resp.read().decode())
            tag = data.get("tag_name", "")
            return {
                "tag": tag,
                "url": data.get("html_url", ""),
                "newer": _parse_version(tag) > _parse_version(__version__),
            }
        except Exception:
            continue
    return None
