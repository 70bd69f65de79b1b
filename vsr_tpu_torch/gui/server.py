"""HTTP layer of the browser GUI (stdlib http.server, JSON API): the port's
counterpart of ``vsr_tpu/gui/server.py``, with the device its workers run
on (``--device``, default cuda). The server process touches no device.

Serves the single-page app in index.html and a small API the page drives.
Endpoint behaviors map one-to-one onto the reference GUI components — see
vsr_tpu_torch/gui/__init__.py for the component map. Binds 127.0.0.1 by default
(a local tool, like the reference's desktop window).

Cross-origin hardening: every /api/* request must carry a per-session random
token (X-VSR-Token header, or ?token= for <img> URLs) that only the served
page knows — a remote web page can neither read the token (same-origin
policy on /) nor send the custom header without a CORS preflight we never
answer. Requests with a mismatched Origin are rejected outright.
"""

from __future__ import annotations

import dataclasses
import json
import os
import secrets
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from vsr_tpu_torch.config import Config, InpaintMode, SubtitleDetectMode
from vsr_tpu_torch.gui.manager import GuiTaskManager

_INDEX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "index.html")

# Slider metadata for the advanced settings panel: every RangeConfigItem the
# reference exposes (backend/config.py:59-103 via
# ui/advanced_setting_interface.py:25-261) with its range.
CONFIG_META: Dict[str, Dict[str, Any]] = {
    "inpaint_mode": {"choices": [m.value for m in InpaintMode]},
    "subtitle_detect_mode": {"choices": [m.value for m in SubtitleDetectMode]},
    "subtitle_yx_axis_difference_pixel": {"min": 0, "max": 300},
    "subtitle_area_deviation_pixel": {"min": 1, "max": 300},
    "subtitle_area_y_axis_difference_pixel": {"min": 0, "max": 300},
    "subtitle_area_pixel_tolerance_y": {"min": 0, "max": 300},
    "subtitle_area_pixel_tolerance_x": {"min": 0, "max": 300},
    "subtitle_timeline_backward_frame_count": {"min": 0, "max": 300},
    "subtitle_timeline_forward_frame_count": {"min": 0, "max": 300},
    "sttn_neighbor_stride": {"min": 1, "max": 100},
    "sttn_reference_length": {"min": 1, "max": 100},
    "sttn_max_load_num": {"min": 1, "max": 300},
    "propainter_max_load_num": {"min": 1, "max": 300},
    "hardware_acceleration": {"bool": True},
    "interface": {"choices": None},  # filled lazily from available_locales()
}


def _config_meta() -> Dict[str, Dict[str, Any]]:
    meta = dict(CONFIG_META)
    if meta["interface"]["choices"] is None:
        from vsr_tpu_torch.i18n import available_locales

        meta["interface"] = {"choices": available_locales()}
    return meta


def _config_dict(cfg: Config) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["inpaint_mode"] = cfg.inpaint_mode.value
    d["subtitle_detect_mode"] = cfg.subtitle_detect_mode.value
    return d


class _FrameCache:
    """One cached cv2.VideoCapture keyed by path (sequential scrubbing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        self._cap = None

    def info(self, path: str) -> Dict[str, Any]:
        import cv2

        if os.path.splitext(path)[-1].lower() in {
                ".png", ".jpg", ".jpeg", ".bmp", ".webp"}:
            img = cv2.imread(path)
            if img is None:
                raise FileNotFoundError(path)
            return {"frames": 1, "fps": 0, "width": img.shape[1],
                    "height": img.shape[0], "image": True}
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(path)
        try:
            return {
                "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                "fps": cap.get(cv2.CAP_PROP_FPS),
                "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                "image": False,
            }
        finally:
            cap.release()

    def frame_jpeg(self, path: str, frame: int, max_w: int = 960) -> bytes:
        import cv2

        with self._lock:
            if os.path.splitext(path)[-1].lower() in {
                    ".png", ".jpg", ".jpeg", ".bmp", ".webp"}:
                img = cv2.imread(path)
            else:
                if self._path != path:
                    if self._cap is not None:
                        self._cap.release()
                    self._cap = cv2.VideoCapture(path)
                    self._path = path
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, frame)
                ok, img = self._cap.read()
                if not ok:
                    img = None
            if img is None:
                raise FileNotFoundError(f"{path}#{frame}")
            if img.shape[1] > max_w:
                s = max_w / img.shape[1]
                img = cv2.resize(img, (max_w, int(img.shape[0] * s)))
            ok, buf = cv2.imencode(".jpg", img,
                                   [cv2.IMWRITE_JPEG_QUALITY, 85])
            return buf.tobytes()


class GuiServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8123,
                 config: Optional[Config] = None,
                 config_path: Optional[str] = None, device: str = "cuda"):
        self.config_path = config_path
        cfg = config or (Config.load(config_path) if config_path else Config())
        self.manager = GuiTaskManager(cfg, device=device)
        self.frames = _FrameCache()
        self.token = secrets.token_hex(16)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            # -- plumbing --
            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj: Any, code: int = 200) -> None:
                self._send(code, json.dumps(obj).encode())

            def _body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def _route(self) -> Tuple[str, Dict[str, str]]:
                parsed = urllib.parse.urlparse(self.path)
                q = {k: v[0] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                return parsed.path, q

            def _authorized(self, q: Dict[str, str]) -> bool:
                """Reject cross-origin requests on /api/*: the Origin (when a
                browser sends one) must match our own host, and the request
                must present the per-session token (header or query)."""
                origin = self.headers.get("Origin")
                if origin and origin not in (None, "null"):
                    o = urllib.parse.urlparse(origin)
                    if o.netloc != self.headers.get("Host", ""):
                        return False
                supplied = (self.headers.get("X-VSR-Token")
                            or q.get("token") or "")
                return secrets.compare_digest(supplied, server.token)

            # -- GET --
            def do_GET(self):
                path, q = self._route()
                if path.startswith("/api/") and not self._authorized(q):
                    self._json({"error": "forbidden"}, 403)
                    return
                try:
                    if path in ("/", "/index.html"):
                        with open(_INDEX, "rb") as f:
                            page = f.read().replace(
                                b"__VSR_TOKEN__", server.token.encode())
                            self._send(200, page, "text/html; charset=utf-8")
                    elif path == "/selection.js":
                        js = os.path.join(os.path.dirname(_INDEX),
                                          "selection.js")
                        with open(js, "rb") as f:
                            self._send(200, f.read(),
                                       "application/javascript")
                    elif path == "/api/state":
                        self._json(server.manager.state())
                    elif path == "/api/config":
                        self._json({"config": _config_dict(server.manager.config),
                                    "meta": _config_meta()})
                    elif path == "/api/i18n":
                        from vsr_tpu_torch.i18n import Translator

                        self._json(Translator(
                            server.manager.config.interface)["GUI"])
                    elif path == "/api/video_info":
                        self._json(server.frames.info(q["path"]))
                    elif path == "/api/frame":
                        jpeg = server.frames.frame_jpeg(
                            q["path"], int(q.get("frame", 0)))
                        self._send(200, jpeg, "image/jpeg")
                    elif path.startswith("/api/preview/"):
                        i = int(path.rsplit("/", 1)[1])
                        jpeg = server.manager.preview_jpeg(i)
                        if jpeg is None:
                            self._json({"error": "no preview yet"}, 404)
                        else:
                            self._send(200, jpeg, "image/jpeg")
                    else:
                        self._json({"error": "not found"}, 404)
                except FileNotFoundError as e:
                    self._json({"error": f"not found: {e}"}, 404)
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}"}, 500)

            # -- POST --
            def do_POST(self):
                path, q = self._route()
                if not self._authorized(q):
                    self._json({"error": "forbidden"}, 403)
                    return
                try:
                    body = self._body()
                    if path == "/api/tasks":
                        ids = [server.manager.add(p)
                               for p in body.get("paths", [])]
                        self._json({"added": ids})
                    elif path == "/api/run":
                        self._json({"started": server.manager.start()})
                    elif path == "/api/stop":
                        server.manager.stop()
                        self._json({"stopped": True})
                    elif path == "/api/config":
                        server.update_config(body)
                        self._json({"config": _config_dict(
                            server.manager.config)})
                    elif path.startswith("/api/task/"):
                        _, _, _, idx, action = path.split("/", 4)
                        i = int(idx)
                        if action == "remove":
                            self._json({"removed": server.manager.remove(i)})
                        elif action == "options":
                            ok = server.manager.set_options(
                                i,
                                sub_areas=body.get("sub_areas"),
                                ab_sections=body.get("ab_sections"),
                                output_path=body.get("output_path"),
                            )
                            self._json({"updated": ok})
                        else:
                            self._json({"error": "unknown action"}, 404)
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # live-editable settings (the settings panels write through here and the
    # reference persists on change, qconfig.save semantics)
    def update_config(self, updates: Dict[str, Any]) -> None:
        d = _config_dict(self.manager.config)
        d.update(updates)
        self.manager.config = Config.from_json(json.dumps(d))
        if self.config_path:
            self.manager.config.save(self.config_path)

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.manager.stop()
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(5)
        self.httpd.server_close()

    def serve_forever(self) -> None:
        print(f"vsr_tpu_torch GUI listening on {self.address} "
              f"(workers on {self.manager.device})")
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m vsr_tpu_torch.gui",
                                 description="vsr_tpu_torch browser GUI")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--config", default=os.path.join("config", "config.json"),
                    help="config JSON persisted on settings change")
    ap.add_argument("--device", default="cuda",
                    help="torch device the task workers run on (default: cuda)")
    args = ap.parse_args(argv)
    GuiServer(args.host, args.port, config_path=args.config,
              device=args.device).serve_forever()
    return 0
