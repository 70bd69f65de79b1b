"""The port's browser GUI (vsr_tpu_torch/gui): every case of
tests/test_gui.py against the port's GuiServer with its workers on the CPU,
and parity with vsr_tpu's GUI: the same calls give equal /api/config and
/api/state, the static assets are vsr_tpu's with the package renamed, and
one video through both packages' _gui_worker (tiny STTN weights written once
by vsr_tpu's save_params) gives frames within 2 uint8.

Covers the reference GUI behaviors the web app replaces (see
vsr_tpu_torch/gui/__init__.py): task queue CRUD, per-task sub-area/AB
options, settings read/write with range metadata, frame/video-info
endpoints for the preview canvas, and end-to-end runs through the worker
in a thread (the spawned worker is covered by tests/test_torch_tasks.py).
"""

import json
import os
import time
import urllib.request

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest

from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.gui.server import GuiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_STTN = dict(channel=16, stack_num=2)


_TOKEN = [""]  # per-session API token, set by the server fixture


def _req(base, path, body=None, token=None, origin=None):
    headers = {"Content-Type": "application/json",
               "X-VSR-Token": _TOKEN[0] if token is None else token}
    if origin is not None:
        headers["Origin"] = origin
    req = urllib.request.Request(
        base + path,
        data=None if body is None else json.dumps(body).encode(),
        headers=headers,
        method="GET" if body is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        data = r.read()
        if r.headers.get("Content-Type", "").startswith("application/json"):
            return json.loads(data)
        return data


@pytest.fixture()
def server(tmp_path):
    cfg = Config()
    cfg.compute_dtype = "float32"
    srv = GuiServer(port=0, config=cfg,
                    config_path=str(tmp_path / "config.json"), device="cpu")
    srv.start()
    _TOKEN[0] = srv.token
    yield srv
    srv.stop()


@pytest.fixture()
def video(tmp_path):
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (96, 80))
    for i in range(12):
        w.write(np.full((80, 96, 3), 100 + i, np.uint8))
    w.release()
    return path


def test_index_and_config_roundtrip(server, tmp_path):
    base = server.address
    html = _req(base, "/")
    assert b"vsr_tpu_torch" in html and b"frameCanvas" in html

    got = _req(base, "/api/config")
    assert got["config"]["inpaint_mode"] == "sttn-auto"
    assert got["meta"]["sttn_max_load_num"] == {"min": 1, "max": 300}

    _req(base, "/api/config", {"inpaint_mode": "lama",
                               "sttn_max_load_num": 60})
    got = _req(base, "/api/config")
    assert got["config"]["inpaint_mode"] == "lama"
    assert got["config"]["sttn_max_load_num"] == 60
    # persisted like the reference's qconfig.save
    saved = Config.load(str(tmp_path / "config.json"))
    assert saved.inpaint_mode == InpaintMode.LAMA


def test_api_rejects_cross_origin_and_missing_token(server):
    """CSRF hardening: /api/* requires the per-session token, and requests
    bearing a foreign Origin are rejected even with it."""
    base = server.address
    html = _req(base, "/")
    assert server.token.encode() in html  # page receives the session token

    for path, body in [("/api/state", None), ("/api/config", None),
                       ("/api/tasks", {"paths": ["/etc/hostname"]}),
                       ("/api/run", {}),
                       ("/api/video_info?path=/etc/hostname", None)]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, path, body, token="")
        assert e.value.code == 403
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, "/api/state", origin="http://evil.example")
    assert e.value.code == 403
    # same-origin with the token still works
    host = base.split("//", 1)[1]
    assert "tasks" in _req(base, "/api/state", origin=f"http://{host}")
    # <img> URLs pass the token as a query parameter
    req = urllib.request.Request(f"{base}/api/state?token={server.token}")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200


def test_preview_follows_task_after_removal(server, video):
    """Previews are keyed by task identity, not queue position: removing a
    lower-index task must not remap a live preview onto the wrong task."""
    base = server.address
    _req(base, "/api/tasks", {"paths": [video, video]})
    uid1 = server.manager.tasks[1].uid
    server.manager._previews[uid1] = b"jpegbytes"
    assert _req(base, "/api/state")["tasks"][1]["has_preview"]
    assert _req(base, "/api/task/0/remove", {})["removed"]
    st = _req(base, "/api/state")
    assert st["tasks"][0]["has_preview"]  # shifted task kept its preview
    assert _req(base, "/api/preview/0") == b"jpegbytes"


def test_i18n_endpoint(server):
    base = server.address
    labels = _req(base, "/api/i18n")
    assert labels["Tasks"] == "Tasks"
    meta = _req(base, "/api/config")["meta"]
    assert "ch" in meta["interface"]["choices"]
    _req(base, "/api/config", {"interface": "ch"})
    labels = _req(base, "/api/i18n")
    assert labels["Tasks"] == "任务"


def test_task_crud_and_options(server, video):
    base = server.address
    added = _req(base, "/api/tasks", {"paths": [video, video]})
    assert added["added"] == [0, 1]

    st = _req(base, "/api/state")
    assert len(st["tasks"]) == 2
    assert st["tasks"][0]["status"] == "pending"
    assert st["tasks"][0]["output_path"].endswith("clip_no_sub.mp4")

    ok = _req(base, f"/api/task/0/options",
              {"sub_areas": [[60, 78, 10, 90]], "ab_sections": [[2, 9]]})
    assert ok["updated"]
    st = _req(base, "/api/state")
    assert st["tasks"][0]["sub_areas"] == [[60, 78, 10, 90]]
    assert st["tasks"][0]["ab_sections"] == [[2, 9]]

    assert _req(base, "/api/task/1/remove", {})["removed"]
    st = _req(base, "/api/state")
    assert len(st["tasks"]) == 1


def test_video_info_and_frame(server, video):
    base = server.address
    info = _req(base, f"/api/video_info?path={video}")
    assert (info["frames"], info["width"], info["height"]) == (12, 96, 80)
    jpeg = _req(base, f"/api/frame?path={video}&frame=3")
    img = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
    assert img.shape == (80, 96, 3)
    # missing preview -> 404
    with pytest.raises(urllib.error.HTTPError):
        _req(base, "/api/preview/0")


class _ThreadProc:
    """Process-shim running the worker in-process so the tiny-model
    monkeypatch reaches it (the real subprocess spawn path is covered by
    tests/test_torch_tasks.py's TaskRunner test — same RemoteCall
    machinery)."""

    def __init__(self, target, args):
        import threading

        self.exitcode = None
        self.pid = os.getpid()

        def run():
            target(*args)
            self.exitcode = 0

        self._t = threading.Thread(target=run, daemon=True)

    def start(self):
        self._t.start()

    def join(self, timeout=None):
        self._t.join(timeout)

    def is_alive(self):
        return self._t.is_alive()

    def terminate(self):
        pass


def test_end_to_end_run(server, video, monkeypatch, tmp_path):
    """Add -> run -> completed -> preview bytes, with a 2-block STTN; the
    worker's first log line names its device."""
    _patch_tiny_sttn(monkeypatch)
    from vsr_tpu_torch.gui import manager as mgr_mod

    def thread_spawn(task, output, queue):
        proc = _ThreadProc(
            mgr_mod._gui_worker,
            (task.path, output, task.options,
             server.manager.config.to_json(), server.manager.device, queue))
        proc.start()
        return proc

    monkeypatch.setattr(server.manager, "_spawn", thread_spawn)
    monkeypatch.setattr(mgr_mod, "PREVIEW_MIN_INTERVAL_S", 0.0)

    base = server.address
    cfg_updates = {"compute_dtype": "float32", "sttn_max_load_num": 6,
                   "sttn_reference_length": 3, "sttn_neighbor_stride": 2}
    _req(base, "/api/config", cfg_updates)
    out = str(tmp_path / "out.mp4")
    _req(base, "/api/tasks", {"paths": [video]})
    _req(base, "/api/task/0/options",
         {"sub_areas": [[60, 78, 10, 90]], "output_path": out})
    assert _req(base, "/api/run", {})["started"]

    deadline = time.time() + 120
    status = None
    while time.time() < deadline:
        st = _req(base, "/api/state")
        status = st["tasks"][0]["status"]
        if status in ("completed", "failed"):
            break
        time.sleep(0.5)
    assert status == "completed", st["tasks"][0].get("error")
    assert st["tasks"][0]["progress"] == 100
    assert os.path.exists(out)
    # the live preview stream produced a decodable side-by-side jpeg
    jpeg = _req(base, "/api/preview/0")
    img = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
    assert img is not None and img.shape[1] > img.shape[0]  # hconcat pair
    worker_lines = [e["message"] for e in st["logs"] if e["task"] == "clip.mp4"]
    assert worker_lines[0] == "device: cpu (host CPU)"


def test_image_task_locked_to_lama(server, tmp_path):
    """Image tasks force inpaint_mode=lama for the worker and surface the
    lock in /api/state, mirroring the reference GUI's image-mode lock
    (ui/home_interface.py:619-631)."""

    img_path = str(tmp_path / "pic.png")
    cv2.imwrite(img_path, np.full((40, 60, 3), 90, np.uint8))

    base = server.address
    _req(base, "/api/config", {"inpaint_mode": "sttn-auto"})
    _req(base, "/api/tasks", {"paths": [img_path]})
    st = _req(base, "/api/state")
    assert st["tasks"][0]["is_image"] is True
    assert st["tasks"][0]["inpaint_mode"] == "lama"

    mgr = server.manager
    task = mgr.tasks[0]
    # the config handed to the worker subprocess is the locked one ...
    eff = mgr.effective_config(task)
    assert eff.inpaint_mode == InpaintMode.LAMA
    # ... the user's global selection is untouched ...
    assert mgr.config.inpaint_mode == InpaintMode.STTN_AUTO
    # ... and a video task keeps the user's mode (no lock)
    vid = str(tmp_path / "clip2.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 24, (96, 80))
    w.write(np.zeros((80, 96, 3), np.uint8))
    w.release()
    _req(base, "/api/tasks", {"paths": [vid]})
    st = _req(base, "/api/state")
    assert st["tasks"][1]["is_image"] is False
    assert st["tasks"][1]["inpaint_mode"] == "sttn-auto"


def _patch_tiny_sttn(monkeypatch):
    """The port's sttn-auto builds a 2-block, 16-channel STTN."""
    from vsr_tpu_torch.inpaint import sttn_auto
    from vsr_tpu_torch.models.sttn import STTNGenerator

    monkeypatch.setattr(sttn_auto, "STTNGenerator",
                        lambda **kw: STTNGenerator(**kw, **TINY_STTN))


def _wait_done(base, index=0, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = _req(base, "/api/state")
        if st["tasks"][index]["status"] in ("completed", "failed"):
            return st
        time.sleep(0.2)
    raise AssertionError(f"task {index} not done in {timeout} s")


def test_worker_without_card_fails_task(server, video, monkeypatch):
    """A worker asked for "cuda" where there is none ends its task FAILED
    with the error; it never runs on the CPU."""
    import torch

    from vsr_tpu_torch.gui import manager as mgr_mod

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setattr(server.manager, "device", "cuda")

    def thread_spawn(task, output, queue):
        proc = _ThreadProc(mgr_mod._gui_worker,
                           (task.path, output, task.options,
                            server.manager.config.to_json(), server.manager.device, queue))
        proc.start()
        return proc

    monkeypatch.setattr(server.manager, "_spawn", thread_spawn)
    out = video.replace(".mp4", "_out.mp4")
    _req(server.address, "/api/tasks", {"paths": [video]})
    _req(server.address, "/api/task/0/options", {"output_path": out})
    assert _req(server.address, "/api/run", {})["started"]
    task = _wait_done(server.address)["tasks"][0]
    assert task["status"] == "failed"
    assert "CUDA is not available" in task["error"]
    assert not os.path.exists(out)


def test_gui_main_takes_port_config_and_device(tmp_path, monkeypatch):
    """`python -m vsr_tpu_torch.gui --port 0 --config C --device cuda:1`
    serves a GuiServer persisting to C whose workers run on cuda:1: the
    server itself touches no device, so this runs without a card."""
    from vsr_tpu_torch.gui import server as server_mod

    served = []
    monkeypatch.setattr(server_mod.GuiServer, "serve_forever",
                        lambda self: (served.append(self), self.httpd.server_close()))
    cfg = str(tmp_path / "gui.json")
    assert server_mod.main(["--port", "0", "--config", cfg, "--device", "cuda:1"]) == 0
    (server,) = served
    assert (server.manager.device, server.config_path) == ("cuda:1", cfg)


# ---- parity with vsr_tpu's GUI ----


@pytest.fixture()
def both_servers(tmp_path):
    """vsr_tpu's GuiServer and the port's, on the same default config."""
    from vsr_tpu.config import Config as JaxConfig
    from vsr_tpu.gui.server import GuiServer as JaxGuiServer

    servers = [JaxGuiServer(port=0, config=JaxConfig(),
                            config_path=str(tmp_path / "jax.json")),
               GuiServer(port=0, config=Config(), config_path=str(tmp_path / "torch.json"),
                         device="cpu")]
    for srv in servers:
        srv.start()
    yield servers
    for srv in servers:
        srv.stop()


def test_config_and_state_equal_vsr_tpu(both_servers, video, tmp_path):
    """The same calls to both packages' servers give equal /api/config
    (values and slider metadata) and equal /api/state."""
    img = str(tmp_path / "pic.png")
    cv2.imwrite(img, np.full((40, 60, 3), 90, np.uint8))
    calls = [("/api/config", {"inpaint_mode": "sttn-det", "sttn_max_load_num": 40,
                              "interface": "ch"}),
             ("/api/tasks", {"paths": [video, img, video]}),
             ("/api/task/0/options", {"sub_areas": [[60, 78, 10, 90]], "ab_sections": [[2, 9]]}),
             ("/api/task/2/options", {"output_path": str(tmp_path / "x.mp4")}),
             ("/api/task/1/remove", {})]
    answers = []
    for srv in both_servers:
        _TOKEN[0] = srv.token
        got = [_req(srv.address, path, body) for path, body in calls]
        got += [_req(srv.address, path) for path in ("/api/config", "/api/state", "/api/i18n")]
        got.append(_req(srv.address, f"/api/video_info?path={video}"))
        answers.append(got)
    want, got = answers
    assert got == want
    assert got[-3]["tasks"][0]["sub_areas"] == [[60, 78, 10, 90]]


def test_static_assets_equal_vsr_tpu_with_package_renamed(server):
    """index.html, selection.js and selection_vectors.json are vsr_tpu's
    with the package name replaced, and the server sends them so."""
    import re

    jax_dir = os.path.join(REPO, "vsr_tpu", "gui")
    port_dir = os.path.join(REPO, "vsr_tpu_torch", "gui")
    port = {}
    for name in ("index.html", "selection.js", "selection_vectors.json"):
        with open(os.path.join(jax_dir, name)) as f:
            want = re.sub(r"\bvsr_tpu\b", "vsr_tpu_torch", f.read())
        with open(os.path.join(port_dir, name)) as f:
            port[name] = f.read()
        assert port[name] == want, name
    assert _req(server.address, "/selection.js").decode() == port["selection.js"]
    page = _req(server.address, "/").decode()
    assert page == port["index.html"].replace("__VSR_TOKEN__", server.token)


def test_gui_worker_matches_vsr_tpu(video, tmp_path, monkeypatch):
    """One video, sub-area and set of tiny STTN weights (written once by
    vsr_tpu's save_params into a models directory both read through
    VSR_TPU_MODELS) through both packages' _gui_worker in this thread: both
    finish, and the frames each hands its encoder agree within 2 uint8, as
    do the encoded files."""
    import queue

    import jax
    import vsr_tpu.pipeline as jpipe
    import vsr_tpu_torch.pipeline as tpipe
    from vsr_tpu.convert.params_io import save_params
    from vsr_tpu.gui import manager as jax_mgr
    from vsr_tpu.inpaint import sttn_auto as jax_sttn
    from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
    from vsr_tpu_torch.gui import manager as mgr_mod
    from vsr_tpu_torch.tasks import TaskOptions

    models = tmp_path / "models"
    models.mkdir()
    params = FlaxSTTN(variant="auto", **TINY_STTN).init(
        jax.random.PRNGKey(4), np.zeros((1, 1, 120, 640, 3), np.float32))
    save_params(str(models / "sttn_auto.npz"), params)
    monkeypatch.setenv("VSR_TPU_MODELS", str(models))
    monkeypatch.setattr(jax_sttn, "STTNGenerator", lambda **kw: FlaxSTTN(**kw, **TINY_STTN))
    _patch_tiny_sttn(monkeypatch)

    cfg = Config()
    cfg.compute_dtype = "float32"
    cfg.sttn_max_load_num = 6
    cfg.sttn_reference_length = 3
    cfg.sttn_neighbor_stride = 2
    written, files = [], []
    for pipe, worker, extra in ((jpipe, jax_mgr._gui_worker, ()),
                                (tpipe, mgr_mod._gui_worker, ("cpu",))):
        frames = []

        class Recording(pipe.VideoWriter):
            def write(self, frame):
                frames.append(frame.copy())
                super().write(frame)

        monkeypatch.setattr(pipe, "VideoWriter", Recording)
        out = str(tmp_path / f"{pipe.__name__}.mp4")
        q = queue.Queue()
        worker(video, out, TaskOptions(sub_areas=[(60, 78, 10, 90)]), cfg.to_json(), *extra, q)
        commands = []
        while not q.empty():
            commands.append(q.get())
        assert ("finish", {"output": out}) in commands, commands
        written.append(np.stack(frames).astype(int))
        cap, decoded = cv2.VideoCapture(out), []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            decoded.append(frame)
        cap.release()
        files.append(np.stack(decoded).astype(int))
    (want, got), (want_file, got_file) = written, files
    assert got.shape == want.shape == (12, 80, 96, 3)
    assert np.abs(got - want).max() <= 2
    assert got_file.shape == want_file.shape
    assert np.abs(got_file - want_file).max() <= 2
    src = np.full((12, 80, 96, 3), 100, int) + np.arange(12)[:, None, None, None]
    assert np.abs(got - src).max() > 0  # the band was rewritten
