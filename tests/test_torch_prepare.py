"""The port's model bootstrap (vsr_tpu_torch/prepare.py, --prepare-models),
as tests/test_prepare.py tests the JAX package's: the filesplit merge byte
for byte, the orchestration with stub converters, error isolation, and real
conversions of synthetic reference checkpoints. Both packages' prepare_models
on one tree write the same .npz files, and the port's runs where jax cannot
be imported."""

import csv
import os
import subprocess
import sys

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

from tests.test_convert import synthetic_torch_state_dict
from tests.test_convert_raft import build_raft_things_state_dict
from tests.test_torch_convert import LAMA_NARROW, STTN_TINY
from vsr_tpu_torch.prepare import FAMILIES, load_into_port, merge_split_blobs, prepare_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_split(directory, name, payload, part_size):
    os.makedirs(directory, exist_ok=True)
    stem, ext = os.path.splitext(name)
    rows = []
    for i in range(0, len(payload), part_size):
        part = payload[i : i + part_size]
        fname = f"{stem}_{i // part_size + 1}{ext}"
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(part)
        rows.append({"filename": fname, "filesize": len(part),
                     "encoding": "", "header": ""})
    with open(os.path.join(directory, "fs_manifest.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["filename", "filesize", "encoding", "header"])
        w.writeheader()
        w.writerows(rows)


def _no_check(family, path):
    pass


class TestMerge:
    def test_merge_byte_exact_and_in_order(self, tmp_path):
        """Parts are concatenated in manifest order, not file-name order
        (part 10 sorts before part 2 by name)."""
        payload = bytes(range(256)) * 100 + b"tail"
        d = str(tmp_path / "big-lama")
        _write_split(d, "big-lama.pt", payload, 2000)
        out = merge_split_blobs(d)
        assert out == os.path.join(d, "big-lama.pt")
        with open(out, "rb") as f:
            assert f.read() == payload
        assert not os.path.exists(out + ".merging")

    def test_merge_idempotent(self, tmp_path):
        d = str(tmp_path / "m")
        _write_split(d, "ProPainter.pth", b"abcdef", 4)
        first = merge_split_blobs(d)
        mtime = os.path.getmtime(first)
        assert merge_split_blobs(d) == first
        assert os.path.getmtime(first) == mtime  # not rewritten

    def test_no_manifest(self, tmp_path):
        assert merge_split_blobs(str(tmp_path)) is None

    def test_missing_part_raises(self, tmp_path):
        d = str(tmp_path / "m")
        _write_split(d, "x.bin", b"0123456789", 4)
        os.remove(os.path.join(d, "x_2.bin"))
        with pytest.raises(FileNotFoundError):
            merge_split_blobs(d)

    def test_size_mismatch_raises_and_writes_nothing(self, tmp_path):
        d = str(tmp_path / "m")
        _write_split(d, "x.bin", b"0123456789", 4)
        with open(os.path.join(d, "x_2.bin"), "ab") as f:
            f.write(b"!")
        with pytest.raises(IOError, match="manifest"):
            merge_split_blobs(d)
        assert not os.path.exists(os.path.join(d, "x.bin"))


class TestPrepare:
    def _layout(self, tmp_path, families):
        src = tmp_path / "models"
        for family, rel, _ in FAMILIES:
            if family in families:
                p = src / rel
                p.parent.mkdir(parents=True, exist_ok=True)
                p.write_bytes(b"ckpt")
        return str(src)

    def test_families_match_vsr_tpu(self):
        from vsr_tpu.prepare import FAMILIES as JAX_FAMILIES

        assert FAMILIES == JAX_FAMILIES

    def test_orchestration_with_stub_converter(self, tmp_path):
        src = self._layout(tmp_path, {"sttn-auto", "raft"})
        out = str(tmp_path / "npz")
        calls, checks = [], []

        def fake_convert(family, path):
            calls.append((family, path))
            return {"params": {"w": np.zeros((2, 2), np.float32)}}

        logs = []
        results = prepare_models(src, out, convert_fn=fake_convert, log=logs.append,
                                 check_fn=lambda f, p: checks.append((f, p)))
        assert results["sttn-auto"] == "converted"
        assert results["raft"] == "converted"
        assert all(results[f] == "missing" for f in results
                   if f not in ("sttn-auto", "raft"))
        assert sorted(c[0] for c in calls) == ["raft", "sttn-auto"]
        assert sorted(checks) == [("raft", os.path.join(out, "raft.npz")),
                                  ("sttn-auto", os.path.join(out, "sttn_auto.npz"))]
        assert any("missing sources" in line for line in logs)
        assert any("2/8 families ready" in line for line in logs)

        # second run: up to date, converter not re-invoked
        calls.clear()
        results = prepare_models(src, out, convert_fn=fake_convert, log=logs.append,
                                 check_fn=_no_check)
        assert results["sttn-auto"] == "exists" and not calls

    def test_split_blob_merged_before_convert(self, tmp_path):
        src = tmp_path / "models"
        _write_split(str(src / "big-lama"), "big-lama.pt", b"blobdata", 3)
        out = str(tmp_path / "npz")
        seen = {}

        def fake_convert(family, path):
            with open(path, "rb") as f:
                seen[family] = f.read()
            return {"params": {"w": np.ones((1,), np.float32)}}

        results = prepare_models(str(src), out, convert_fn=fake_convert,
                                 log=lambda s: None, check_fn=_no_check)
        assert results["lama"] == "converted"
        assert seen["lama"] == b"blobdata"

    def test_converter_error_is_isolated(self, tmp_path):
        src = self._layout(tmp_path, {"sttn-auto", "sttn-det"})
        out = str(tmp_path / "npz")

        def fake_convert(family, path):
            if family == "sttn-auto":
                raise ValueError("corrupt checkpoint")
            return {"params": {"w": np.zeros((1,), np.float32)}}

        results = prepare_models(src, out, convert_fn=fake_convert,
                                 log=lambda s: None, check_fn=_no_check)
        assert results["sttn-auto"].startswith("error")
        assert results["sttn-det"] == "converted"

    def test_corrupt_split_blob_is_an_error_not_missing(self, tmp_path):
        src = tmp_path / "models"
        _write_split(str(src / "big-lama"), "big-lama.pt", b"blobdata", 3)
        os.remove(str(src / "big-lama" / "big-lama_2.pt"))  # corrupt the set
        results = prepare_models(
            str(src), str(tmp_path / "npz"),
            convert_fn=lambda f, p: {"params": {}}, log=lambda s: None, check_fn=_no_check)
        assert results["lama"].startswith("error: split-blob merge failed")
        assert results["sttn-auto"] == "missing"

    def test_failed_load_check_is_an_error(self, tmp_path):
        """A converted file that does not load strict into the port's module
        (here: a narrow STTN against the pipeline's full-width one) is an
        error, and its file is removed so that a rerun does not read it as
        up to date."""
        src = tmp_path / "models"
        (src / "sttn-auto").mkdir(parents=True)
        sd = {k: torch.from_numpy(v) for k, v in synthetic_torch_state_dict(16, 2).items()}
        torch.save({"netG": sd}, str(src / "sttn-auto" / "infer_model.pth"))
        out = tmp_path / "npz"
        results = prepare_models(str(src), str(out), families=["sttn-auto"],
                                 log=lambda s: None)
        assert results["sttn-auto"].startswith("error") and "size mismatch" in results["sttn-auto"]
        assert not (out / "sttn_auto.npz").exists()

    def test_real_conversion_loads_into_port(self, tmp_path):
        """A full-width raft-things.pth through the real converter and the
        default check (a strict load into the pipeline's RAFT), then the
        written .npz gives that RAFT the .pth's parameters."""
        from vsr_tpu_torch.inpaint.weights import load_raft_weights
        from vsr_tpu_torch.models.propainter.raft import RAFT

        src = tmp_path / "models"
        (src / "propainter").mkdir(parents=True)
        pth = str(src / "propainter" / "raft-things.pth")
        torch.save({k: torch.from_numpy(v) for k, v in build_raft_things_state_dict().items()},
                   pth)
        out = str(tmp_path / "npz")
        assert prepare_models(str(src), out, families=["raft"],
                              log=lambda s: None) == {"raft": "converted"}
        a, b = RAFT(), RAFT()
        load_raft_weights(a, pth)
        load_raft_weights(b, os.path.join(out, "raft.npz"))
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k


def _reference_tree(root):
    """A reference-format models tree at narrow widths: STTN (both), a raw
    big-lama .pth split into filesplit parts, raft-things.pth with its
    'module.' prefixes, the flow completion and generator checkpoints. No
    V5/: both DBNet families are missing."""
    from tests.reference_compat import build_torch_lama
    from tests.test_convert_propainter import (
        build_flow_completion_state_dict,
        build_generator_state_dict,
    )
    from tests.test_torch_convert import GEN_TINY, _tensors

    root.mkdir()
    for sub, name, seed in (("sttn-auto", "infer_model.pth", 0), ("sttn-det", "sttn.pth", 1)):
        (root / sub).mkdir()
        sd = synthetic_torch_state_dict(channel=16, stack=2)
        if seed:
            sd = {k: v + seed for k, v in sd.items()}
        torch.save({"netG": _tensors(sd)}, str(root / sub / name))
    torch.manual_seed(0)
    lama = str(root / "big-lama.pt")
    torch.save(build_torch_lama(**LAMA_NARROW).state_dict(), lama)
    with open(lama, "rb") as f:
        payload = f.read()
    os.remove(lama)
    _write_split(str(root / "big-lama"), "big-lama.pt", payload, len(payload) // 3 + 1)
    (root / "propainter").mkdir()
    torch.save(_tensors(build_raft_things_state_dict()), str(root / "propainter" / "raft-things.pth"))
    torch.save(_tensors(build_flow_completion_state_dict()),
               str(root / "propainter" / "recurrent_flow_completion.pth"))
    torch.save(_tensors(build_generator_state_dict(**GEN_TINY)),
               str(root / "propainter" / "ProPainter.pth"))
    return str(root)


def test_both_packages_write_equal_npz(tmp_path):
    """vsr_tpu's prepare_models and the port's on one reference tree: the
    same statuses, and .npz files with the same keys, dtypes and arrays."""
    from vsr_tpu.prepare import prepare_models as jax_prepare_models

    src = _reference_tree(tmp_path / "models")
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    got = prepare_models(src, ours, log=lambda s: None, check_fn=_no_check)
    want = jax_prepare_models(src, theirs, log=lambda s: None)
    assert got == want
    assert sorted(s for s in got.values()) == ["converted"] * 6 + ["missing"] * 2
    for _, _, name in FAMILIES:
        if not os.path.exists(os.path.join(theirs, name)):
            assert not os.path.exists(os.path.join(ours, name))
            continue
        with np.load(os.path.join(ours, name)) as a, np.load(os.path.join(theirs, name)) as b:
            assert a.files == b.files, name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)


def test_load_into_port_narrow_families(tmp_path):
    """load_into_port's families map to the port's loaders: a narrow STTN
    .npz loads into a narrow STTN by the same loader, and an unknown
    family raises."""
    from vsr_tpu_torch.convert.params_io import save_params
    from vsr_tpu_torch.convert.torch_sttn import convert_sttn_state_dict
    from vsr_tpu_torch.inpaint.weights import load_sttn_weights
    from vsr_tpu_torch.models.sttn import STTNGenerator
    from vsr_tpu_torch.prepare import _port_model

    npz = str(tmp_path / "sttn_det.npz")
    save_params(npz, convert_sttn_state_dict(synthetic_torch_state_dict(16, 2)))
    model, load = _port_model("sttn-det")
    assert load is load_sttn_weights and model.variant == "det"
    load(STTNGenerator(variant="det", **STTN_TINY), npz)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_into_port("sttn-det", npz)
    with pytest.raises(ValueError, match="unknown family"):
        load_into_port("i3d", npz)


def test_cli_prepare_models_without_jax(tmp_path):
    """`python -m vsr_tpu_torch --prepare-models SRC --models OUT` in a
    process where importing jax, flax or vsr_tpu fails: full-width RAFT
    converted and checked, every other family missing, rc 0."""
    src = tmp_path / "models"
    (src / "propainter").mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in build_raft_things_state_dict().items()},
               str(src / "propainter" / "raft-things.pth"))
    out = str(tmp_path / "out")
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'flax', 'vsr_tpu'):\n"
        "    sys.modules[name] = None  # import raises ImportError\n"
        f"sys.argv = ['vsr_tpu_torch', '--prepare-models', {str(src)!r}, '--models', {out!r}]\n"
        "runpy.run_module('vsr_tpu_torch', run_name='__main__')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[prepare] raft: propainter/raft-things.pth -> raft.npz" in proc.stdout
    assert "[prepare] 1/8 families ready" in proc.stdout
    assert os.listdir(out) == ["raft.npz"]


def test_cli_prepare_models_flag(tmp_path, monkeypatch):
    from vsr_tpu_torch import cli
    import vsr_tpu_torch.prepare as prep

    called = {}

    def fake_prepare(src, out):
        called["args"] = (src, out)
        return {"sttn-auto": "converted"}

    monkeypatch.setattr(prep, "prepare_models", fake_prepare)
    rc = cli.main(["--prepare-models", str(tmp_path), "--models", str(tmp_path / "o")])
    assert rc == 0
    assert called["args"] == (str(tmp_path), str(tmp_path / "o"))
    monkeypatch.chdir(tmp_path)
    cli.main(["--prepare-models", str(tmp_path)])
    assert called["args"] == (str(tmp_path), "models_npz")


def test_cli_prepare_models_error_rc(tmp_path, monkeypatch):
    from vsr_tpu_torch import cli
    import vsr_tpu_torch.prepare as prep

    monkeypatch.setattr(prep, "prepare_models", lambda s, o: {"lama": "error: boom"})
    assert cli.main(["--prepare-models", str(tmp_path)]) == 1
