"""The port's warm-up (vsr_tpu_torch/warmup.py, --warmup) and release check
(--check-update), as tests/test_warmup.py and the JAX package's CLI test
them: each mode runs once on the CPU with the models shrunk the way
tests/test_warmup.py shrinks them, the native builds run only on CUDA and
their failures raise, and the CLI flags route and print as vsr_tpu's do."""

import functools
import io
import json
import urllib.error

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import pytest
import torch

from vsr_tpu_torch import warmup as warmup_mod
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.warmup import DEFAULT_MODES, DEFAULT_SIZES, warmup

STTN_TINY = dict(channel=16, stack_num=2, patchsizes_override=((4, 3), (2, 2)))


def small_config():
    cfg = Config()
    cfg.compute_dtype = "float32"
    cfg.sttn_neighbor_stride = 2
    cfg.sttn_reference_length = 2
    cfg.propainter_neighbor_length = 4
    cfg.propainter_ref_stride = 4
    cfg.propainter_subvideo_length = 8
    cfg.propainter_raft_iters = 2
    return cfg


def test_defaults_match_vsr_tpu():
    from vsr_tpu import warmup as jax_warmup

    assert DEFAULT_MODES == jax_warmup.DEFAULT_MODES
    assert DEFAULT_SIZES == jax_warmup.DEFAULT_SIZES


def test_warmup_sttn_and_lama(monkeypatch, capsys):
    import vsr_tpu_torch.inpaint.lama as lama_mod
    import vsr_tpu_torch.inpaint.sttn_auto as auto_mod
    import vsr_tpu_torch.inpaint.sttn_det as det_mod
    from vsr_tpu_torch.models.lama import LamaGenerator
    from vsr_tpu_torch.models.sttn import STTNGenerator

    for mod in (auto_mod, det_mod):
        monkeypatch.setattr(mod, "STTNGenerator", lambda **kw: STTNGenerator(**kw, **STTN_TINY))
    monkeypatch.setattr(auto_mod, "STTNAutoInpainter",
                        functools.partial(auto_mod.STTNAutoInpainter, input_size=(32, 24)))
    monkeypatch.setattr(det_mod, "STTNDetInpainter",
                        functools.partial(det_mod.STTNDetInpainter, input_size=(64, 48)))
    monkeypatch.setattr(lama_mod, "LamaGenerator",
                        lambda **kw: LamaGenerator(ngf=8, n_downsampling=2, n_blocks=1))
    builds = []
    monkeypatch.setattr(warmup_mod, "build_native", lambda: builds.append(1))
    done = warmup(
        modes=["sttn-auto", "sttn-det", "lama", "opencv"],
        sizes=[(48, 64)],
        config=small_config(),
        clip_len=6,
        device="cpu",
    )
    # opencv is host-only: nothing to run, skipped from the done list
    assert done == ["sttn-auto", "sttn-det", "lama"]
    assert not builds  # the native libraries are built only for a CUDA device
    out = capsys.readouterr().out
    for mode in done:
        assert f"[warmup] {mode}: ready in " in out


def test_warmup_propainter(monkeypatch):
    import vsr_tpu_torch.inpaint.propainter as pp_mod

    monkeypatch.setattr(
        pp_mod, "PropainterInpainter",
        functools.partial(
            pp_mod.PropainterInpainter,
            generator_kwargs=dict(channel=16, hidden=32, depths=1, n_head=2,
                                  window_size=(3, 4), pool_size=(2, 2)),
            raft_kwargs=dict(corr_levels=2, corr_radius=2)))
    # w=344 -> band split_h 64: tall enough for the corr pyramid
    done = warmup(modes=["propainter"], sizes=[(80, 344)], config=small_config(),
                  clip_len=8, device="cpu")
    assert done == ["propainter"]


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown warmup mode"):
        warmup(modes=["bogus"], device="cpu")


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        warmup(modes=[], device="cuda")


def test_cuda_builds_native_libraries_first(monkeypatch, capsys):
    """On a CUDA device both libraries are built (nvcc, then g++) before
    any mode runs, and each build's seconds are logged; a build that fails
    raises with the compiler's output."""
    from vsr_tpu_torch import native
    from vsr_tpu_torch.ops import _build

    calls = []
    monkeypatch.setattr(warmup_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "build", lambda: calls.append("nvcc"))
    monkeypatch.setattr(native, "build", lambda: calls.append("g++"))
    assert warmup(modes=[], device="cuda") == []
    assert calls == ["nvcc", "g++"]
    out = capsys.readouterr().out
    assert "[warmup] build cuda kernels (nvcc): " in out
    assert "[warmup] build host ops (g++): " in out

    def failed():
        raise RuntimeError("nvcc failed (exit 1): nvcc ...\nerror: bad")

    monkeypatch.setattr(_build, "build", failed)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        warmup(modes=["sttn-auto"], device="cuda")


def test_cli_warmup_flag(monkeypatch):
    """--warmup routes through cli.main with its modes, sizes, models
    directory, config and device, and exits 0."""
    import vsr_tpu_torch.cli as cli

    calls = {}

    def fake_warmup(**kw):
        calls.update(kw)
        return list(kw["modes"])

    monkeypatch.setattr(warmup_mod, "warmup", fake_warmup)
    rc = cli.main(["--warmup", "lama", "--warmup-sizes", "48", "64",
                   "--models", "m", "--device", "cpu"])
    assert rc == 0
    assert calls["modes"] == ["lama"]
    assert calls["sizes"] == [(48, 64)]
    assert calls["checkpoint_dir"] == "m" and calls["device"] == "cpu"
    assert isinstance(calls["config"], Config)
    assert cli.main(["--warmup", "--device", "cpu"]) == 0
    assert calls["modes"] == DEFAULT_MODES and calls["sizes"] == list(DEFAULT_SIZES)


def test_cli_warmup_end_to_end_cpu(monkeypatch, tmp_path, capsys):
    """`--warmup sttn-auto --device cpu` for real, with a narrow STTN."""
    import vsr_tpu_torch.cli as cli
    import vsr_tpu_torch.inpaint.sttn_auto as auto_mod
    from vsr_tpu_torch.models.sttn import STTNGenerator

    monkeypatch.setattr(auto_mod, "STTNGenerator", lambda **kw: STTNGenerator(**kw, **STTN_TINY))
    monkeypatch.setattr(auto_mod, "STTNAutoInpainter",
                        functools.partial(auto_mod.STTNAutoInpainter, input_size=(32, 24)))
    cfg_path = str(tmp_path / "config.json")
    small_config().save(cfg_path)
    assert cli.main(["--warmup", "sttn-auto", "--config", cfg_path, "--device", "cpu"]) == 0
    assert "[warmup] sttn-auto: ready in " in capsys.readouterr().out


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("tag,expect", [(None, "release info unreachable"),
                                        ("v9.0.0", "update available v9.0.0"),
                                        ("v0.1.0", "up to date (v0.1.0)")])
def test_cli_check_update(tag, expect, monkeypatch, capsys):
    """--check-update with urlopen stubbed: offline, a newer tag, the same
    version; it prints what vsr_tpu prints, under the port's name, and the
    mirror is tried when the first URL fails."""
    import vsr_tpu_torch.cli as cli
    from vsr_tpu_torch.utils import version_service

    urls = []

    def fake_urlopen(req, timeout):
        urls.append(req.full_url)
        if tag is None or len(urls) == 1:
            raise urllib.error.URLError("offline")
        return _Response(json.dumps({"tag_name": tag, "html_url": "https://x/r"}).encode())

    monkeypatch.setattr(version_service.urllib.request, "urlopen", fake_urlopen)
    assert cli.main(["--check-update"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("vsr_tpu_torch 0.1.0: ") and expect in out
    assert urls == version_service.UPDATE_URLS


def test_version_service_matches_vsr_tpu():
    from vsr_tpu.utils import version_service as jax_vs
    from vsr_tpu_torch.utils import version_service

    assert version_service.UPDATE_URLS == jax_vs.UPDATE_URLS
    for tag in ("v1.4.0", "1.10.2", "v0.1", "", "v2.0.0-beta"):
        assert version_service._parse_version(tag) == jax_vs._parse_version(tag)
