"""The port's sttn-auto slice as a whole: STTNAutoInpainter.process_video
against the JAX package's on the same frames and params, the CLI end to end
on a small mp4, and a check that the port never loads jax."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from vsr_tpu.config import Config
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.masks.mask import create_mask as jax_create_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channel=16, stack_num=2, patchsizes_override=((4, 3), (2, 2)))


def tiny_config():
    cfg = Config()
    cfg.compute_dtype = "float32"
    cfg.sttn_max_load_num = 10
    cfg.sttn_reference_length = 4
    cfg.sttn_neighbor_stride = 2
    cfg.window_batch = 2
    return cfg


def _frames(n, h=120, w=160, seed=0):
    base = np.random.default_rng(seed).integers(40, 200, (h, w, 3), np.uint8)
    return [np.roll(base, 3 * i, axis=1).copy() for i in range(n)]


class _ListReader:
    def __init__(self, frames):
        self._frames = list(frames)

    def read(self):
        if not self._frames:
            return False, None
        return True, self._frames.pop(0).copy()


class _ListWriter:
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame.copy())


@pytest.mark.parametrize("entry", ["process_video", "__call__"])
def test_inpainter_matches_jax(entry, tmp_path, monkeypatch):
    """Same seeded flax params (through a .npz both packages load), same
    30 frames at input_size (64, 48) in fp32, through the streaming entry
    point or the list-in/list-out one: every pixel within 2 uint8 of the JAX
    package's output, and pixels outside the mask untouched."""
    import jax
    from vsr_tpu.inpaint import sttn_auto as jmod
    from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
    from vsr_tpu_torch.inpaint import sttn_auto as tmod
    from vsr_tpu_torch.models.sttn import STTNGenerator

    flax_model = FlaxSTTN(variant="auto", **TINY)
    params = flax_model.init(jax.random.PRNGKey(3), np.zeros((1, 1, 48, 64, 3), np.float32))
    ckpt = str(tmp_path / "sttn_auto.npz")
    save_params(ckpt, params)

    monkeypatch.setattr(jmod, "STTNGenerator",
                        lambda *, variant, dtype, use_pallas: FlaxSTTN(
                            variant=variant, dtype=dtype, use_pallas=use_pallas, **TINY))
    monkeypatch.setattr(tmod, "STTNGenerator",
                        lambda *, variant, use_kernel: STTNGenerator(
                            variant=variant, use_kernel=use_kernel, **TINY))

    frames = _frames(30)
    mask = jax_create_mask((120, 160), [(40, 120, 100, 108)])
    cfg = tiny_config()
    outs = []
    for inpainter in (jmod.STTNAutoInpainter(ckpt, cfg, input_size=(64, 48)),
                      tmod.STTNAutoInpainter(ckpt, cfg, input_size=(64, 48), device="cpu")):
        if entry == "__call__":
            result = inpainter([f.copy() for f in frames], mask)
        else:
            writer = _ListWriter()
            assert inpainter.process_video(
                _ListReader(frames), writer, mask, 30, (160, 120)) == 30
            result = writer.frames
        assert len(result) == 30
        outs.append(np.stack(result).astype(int))
    want, got = outs
    src = np.stack(frames).astype(int)
    outside = np.broadcast_to(mask[None, :, :, None] == 0, src.shape)
    np.testing.assert_array_equal(got[outside], src[outside])
    assert np.abs(got - want).max() <= 2
    assert np.abs(got - src).max() > 0  # the band was rewritten


def test_cli_end_to_end(tmp_path, monkeypatch):
    """`python -m vsr_tpu_torch ... --device cpu` (its main(), in process, so
    the STTN can be shrunk): frame count and size kept, band rewritten."""
    from vsr_tpu_torch import cli
    from vsr_tpu_torch.inpaint import sttn_auto as tmod
    from vsr_tpu_torch.models.sttn import STTNGenerator

    monkeypatch.setattr(tmod, "STTNGenerator",
                        lambda *, variant, use_kernel: STTNGenerator(
                            variant=variant, use_kernel=use_kernel, channel=16,
                            stack_num=1))
    video = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24, (160, 120))
    frames = _frames(20, seed=1)
    for f in frames:
        w.write(f)
    w.release()
    cfg_path = str(tmp_path / "config.json")
    tiny_config().save(cfg_path)
    out = str(tmp_path / "out.mp4")
    assert cli.main(["-i", video, "-o", out, "-c", "100", "112", "40", "120",
                     "--config", cfg_path, "--device", "cpu"]) == 0
    cap = cv2.VideoCapture(out)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, frame = cap.read()
    cap.release()
    assert n == 20 and ok and frame.shape == (120, 160, 3)


@pytest.mark.parametrize("argv,item", [
    (["--gui"], "item 11"),
])
def test_cli_unported_modes_exit_with_roadmap_item(argv, item, monkeypatch):
    """ROADMAP.md item 11 (the GUI) is ported: `--gui --port P --device cpu`
    no longer exits with an error naming the item but builds a GuiServer on
    port P whose workers run on cpu, and serves it (serve_forever patched
    out here)."""
    import socket

    from vsr_tpu_torch import cli
    from vsr_tpu_torch.gui.server import GuiServer

    assert item == "item 11" and argv == ["--gui"]
    with socket.socket() as s:  # a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    served = []
    monkeypatch.setattr(GuiServer, "serve_forever",
                        lambda self: (served.append(self), self.httpd.server_close()))
    assert cli.main(argv + ["--port", str(port), "--device", "cpu"]) == 0
    (server,) = served
    assert server.httpd.server_address[1] == port
    assert server.manager.device == "cpu"
    assert server.config_path == cli.DEFAULT_CONFIG_PATH


def test_picture_input_raises_with_roadmap_item(tmp_path):
    """Picture mode (detection + LaMa) is ported, so an image path no longer
    raises naming ROADMAP.md item 7: it is read at construction (size,
    default output no_sub/<name>.png), and one that cannot be read raises.
    tests/test_torch_lama_pipeline.py runs the mode."""
    import cv2

    from vsr_tpu_torch.pipeline import SubtitleRemover

    with pytest.raises(IOError, match="cannot read image"):
        SubtitleRemover(str(tmp_path / "missing.png"), device="cpu")
    path = str(tmp_path / "pic.jpg")
    cv2.imwrite(path, np.zeros((30, 40, 3), np.uint8))
    remover = SubtitleRemover(path, device="cpu")
    assert remover.is_picture and remover.size == (40, 30) and remover.frame_count == 1
    assert remover.video_out_path == str(tmp_path / "no_sub" / "pic.jpg")


def test_cuda_without_gpu_raises():
    import torch
    from vsr_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_port_never_imports_jax():
    """Every module of vsr_tpu_torch (``convert.__main__`` too: it does
    nothing on import), chip_smoke and kernel_faults imported in a fresh
    process and `python -m vsr_tpu_torch --help` run there: nothing of jax,
    flax or the JAX package vsr_tpu is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vsr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vsr_tpu_torch.__path__, 'vsr_tpu_torch.')]\n"
        "for name in names + ['chip_smoke', 'kernel_faults']:\n"
        "    if name != 'vsr_tpu_torch.__main__':\n"
        "        importlib.import_module(name)\n"
        "sys.argv = ['vsr_tpu_torch', '--help']\n"
        "try:\n"
        "    importlib.import_module('vsr_tpu_torch.__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "assert 'vsr_tpu_torch.pipeline' in sys.modules and 'chip_smoke' in sys.modules\n"
        "assert {'vsr_tpu_torch.inpaint.propainter', 'vsr_tpu_torch.models.propainter.raft',\n"
        "        'vsr_tpu_torch.ops.deform_conv', 'vsr_tpu_torch.scenes.content',\n"
        "        'vsr_tpu_torch.convert.__main__', 'vsr_tpu_torch.convert.paddle_dbnet',\n"
        "        'vsr_tpu_torch.prepare', 'vsr_tpu_torch.warmup', 'vsr_tpu_torch.scenes.detectors',\n"
        "        'vsr_tpu_torch.utils.common', 'vsr_tpu_torch.utils.version_service',\n"
        "        'vsr_tpu_torch.tasks', 'vsr_tpu_torch.utils.remote_call',\n"
        "        'vsr_tpu_torch.utils.process_manager', 'vsr_tpu_torch.utils.tracing',\n"
        "        'vsr_tpu_torch.gui', 'vsr_tpu_torch.gui.__main__', 'vsr_tpu_torch.gui.manager',\n"
        "        'vsr_tpu_torch.gui.selection_model', 'vsr_tpu_torch.gui.server',\n"
        "        'vsr_tpu_torch.parallel', 'vsr_tpu_torch.parallel.mesh',\n"
        "        'vsr_tpu_torch.models.discriminator', 'vsr_tpu_torch.models.vgg',\n"
        "        'vsr_tpu_torch.models.lpips', 'vsr_tpu_torch.utils.metrics', 'vsr_tpu_torch.train',\n"
        "        'vsr_tpu_torch.train.losses', 'vsr_tpu_torch.train.lr_schedulers',\n"
        "        'vsr_tpu_torch.train.scalars', 'vsr_tpu_torch.train.dataset',\n"
        "        'vsr_tpu_torch.train.canny', 'vsr_tpu_torch.train.perceptual',\n"
        "        'vsr_tpu_torch.train.sttn_trainer', 'vsr_tpu_torch.train.train_sttn',\n"
        "        'vsr_tpu_torch.train.propainter_trainer'} <= set(names)\n"
        "assert 'vsr_tpu_torch.convert.__main__' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'vsr_tpu'))\n"
        "print(len(names), bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    pkg = os.path.join(REPO, "vsr_tpu_torch")
    paths = [os.path.join(root, f) for root, _, files in os.walk(pkg)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, f) for f in ("chip_smoke.py", "kernel_faults.py")]


def test_port_sources_do_not_import_vsr_tpu():
    """An ast scan: no `import vsr_tpu...` or `from vsr_tpu... import` in the
    port, chip_smoke.py or kernel_faults.py, other than of vsr_tpu_torch (nor of jax / flax)."""
    import ast

    def foreign(name):
        return name.split(".")[0] in ("vsr_tpu", "jax", "flax")

    found = []
    sources = _port_sources()
    assert len(sources) > 20
    assert any(p.endswith(os.path.join("models", "propainter", "generator.py")) for p in sources)
    for path in sources:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found += [(path, a.name) for a in node.names if foreign(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                if foreign(node.module):
                    found.append((path, node.module))
    assert not found, found
