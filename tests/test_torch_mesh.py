"""Multi-device (mesh) inference of the port (vsr_tpu_torch/parallel/mesh.py
and the inpainters' ``mesh``): the counterparts of tests/test_mesh_modes.py
and tests/test_engine.py::TestMeshSharding, on meshes of CPU devices. A
mesh of two or three entries on one device still splits the work into
shards, pads the tail as on cards, and runs the gather, copy and return
path of each shard (the copies are no-ops here). Each sharded run matches
the single-device run within 1 uint8 with at most 1% of values differing
(LaMa 5%), the bar of tests/test_mesh_modes.py; the sharded STTN window
engine and LaMa band path also match vsr_tpu's on its 8-device cpu_mesh
with the same params (STTN within 2 uint8, LaMa within 1: the repo's torch
parity bars)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detect import _variables
from vsr_tpu.convert.params_io import save_params
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.parallel.mesh import create_mesh, default_inference_mesh, replicate

CPU = torch.device("cpu")
TINY_PATCHES = ((4, 3), (2, 2))
H, W = 24, 32
TINY_LAMA = dict(ngf=8, n_downsampling=2, n_blocks=2)


def _diff_ok(a, b, frac=0.01, limit=1):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.max() <= limit, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


# ---- the mesh helpers ----


def test_default_mesh_is_none_off_a_bare_cuda():
    """A CPU run and a pinned card are never sharded by default."""
    assert default_inference_mesh("cpu") is None
    assert default_inference_mesh("cuda:0") is None
    assert default_inference_mesh(torch.device("cpu")) is None


def test_create_mesh_checks():
    assert create_mesh(["cpu", CPU]) == [CPU, CPU]
    assert create_mesh([CPU] * 3, data=3) == [CPU] * 3
    with pytest.raises(ValueError, match="model=1"):
        create_mesh([CPU, CPU], model=2)
    with pytest.raises(ValueError, match="mixed"):
        create_mesh(["cuda:0", "cpu"])
    with pytest.raises(ValueError, match="replicas"):
        create_mesh([CPU, CPU], data=3)
    with pytest.raises(ValueError, match="at least one"):
        create_mesh([])


def test_replicate_shares_a_device_and_checks_its_type():
    model = torch.nn.Linear(2, 2)
    replicas = replicate(model, [CPU, "cpu", CPU])
    assert replicas == [model] * 3
    with pytest.raises(ValueError, match="mixed"):
        replicate(model, ["cpu", "cuda:1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            replicate(model, ["cuda:0", "cuda:1"])


# ---- STTN window engine ----


@pytest.fixture(scope="module")
def sttn_pair(tmp_path_factory):
    """A tiny flax STTN's params, and the port's model loaded from them."""
    from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
    from vsr_tpu_torch.inpaint.weights import load_sttn_weights
    from vsr_tpu_torch.models.sttn import STTNGenerator

    flax_model = FlaxSTTN(variant="auto", channel=16, stack_num=2,
                          patchsizes_override=TINY_PATCHES)
    params = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    path = str(tmp_path_factory.mktemp("sttn") / "sttn_auto.npz")
    save_params(path, params)
    model = STTNGenerator(variant="auto", channel=16, stack_num=2,
                          patchsizes_override=TINY_PATCHES)
    load_sttn_weights(model, path)
    return flax_model, params, model.float().eval()


def _engine(model, mesh=None, **kw):
    from vsr_tpu_torch.inpaint.engine import STTNWindowEngine

    return STTNWindowEngine(model, CPU, clip_len=20, input_hw=(H, W), stride=5, ref_length=10,
                            window_batch=2, mesh=replicate(model, mesh) if mesh else None, **kw)


def _run(engine, frames, masks=None):
    return engine.fetch(engine.dispatch(frames, masks))


@pytest.mark.parametrize("n_dev", [2, 3])
def test_sharded_windows_match_single_device(sttn_pair, n_dev):
    """20 frames, stride 5: 4 windows in shards of 2 (three devices: padded
    to 6 with all-invalid windows); a 17-frame chunk pads its frames too."""
    _, _, model = sttn_pair
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (20, H, W, 3), dtype=np.uint8)
    sharded = _engine(model, [CPU] * n_dev)
    assert sharded.num_windows_sharded == (4 if n_dev == 2 else 6)
    for t in (20, 17):
        _diff_ok(_run(_engine(model), frames[:t]), _run(sharded, frames[:t]))


def test_sharded_masked_engine_matches_single_device():
    """The det engine's masks follow each shard's windows."""
    from vsr_tpu_torch.inpaint.weights import load_sttn_weights
    from vsr_tpu_torch.models.sttn import STTNGenerator

    model = STTNGenerator(variant="det", channel=16, stack_num=2,
                          patchsizes_override=TINY_PATCHES)
    load_sttn_weights(model, None)  # the seeded random init
    model.eval()
    rng = np.random.default_rng(22)
    frames = rng.integers(0, 256, (20, H, W, 3), dtype=np.uint8)
    masks = np.zeros((20, H, W), np.uint8)
    masks[:, 12:20, 4:28] = 1
    want = _run(_engine(model, masked=True), frames, masks)
    _diff_ok(want, _run(_engine(model, [CPU] * 3, masked=True), frames, masks))


def test_sharded_windows_match_vsr_tpu_mesh(sttn_pair, cpu_mesh):
    """The port's two-replica engine against vsr_tpu's engine on its
    8-device cpu_mesh, same params and frames."""
    from vsr_tpu.inpaint.engine import STTNWindowEngine as JaxEngine

    flax_model, params, model = sttn_pair
    rng = np.random.default_rng(23)
    frames = rng.integers(0, 256, (20, H, W, 3), dtype=np.uint8)
    want = JaxEngine(flax_model, params, clip_len=20, input_hw=(H, W), stride=5,
                     ref_length=10, mesh=cpu_mesh).process_chunk(frames)
    _diff_ok(want, _run(_engine(model, [CPU, CPU]), frames), frac=1.0, limit=2)


@pytest.mark.parametrize("t", [20, 13])
def test_process_chunk_is_dispatch_then_fetch(sttn_pair, t):
    """process_chunk, vsr_tpu's synchronous form, returns what dispatch +
    fetch return, and matches vsr_tpu's process_chunk within 2 uint8."""
    from vsr_tpu.inpaint.engine import STTNWindowEngine as JaxEngine

    flax_model, params, model = sttn_pair
    frames = np.random.default_rng(25).integers(0, 256, (t, H, W, 3), dtype=np.uint8)
    got = _engine(model).process_chunk(frames)
    np.testing.assert_array_equal(got, _run(_engine(model), frames))
    want = JaxEngine(flax_model, params, clip_len=20, input_hw=(H, W), stride=5,
                     ref_length=10).process_chunk(frames)
    assert got.shape == want.shape == (t, H, W, 3)
    _diff_ok(want, got, frac=1.0, limit=2)


def test_sttn_auto_default_mesh(sttn_pair, monkeypatch):
    """STTNAutoInpainter builds its replicas once from default_inference_mesh
    and hands them to every engine; its frames match the unsharded run."""
    from vsr_tpu_torch.inpaint import sttn_auto
    from vsr_tpu_torch.models.sttn import STTNGenerator

    monkeypatch.setattr(sttn_auto, "STTNGenerator", lambda **kw: STTNGenerator(
        **kw, channel=16, stack_num=2, patchsizes_override=TINY_PATCHES))
    cfg = Config(compute_dtype="float32", sttn_max_load_num=10, sttn_reference_length=4,
                 sttn_neighbor_stride=2)
    rng = np.random.default_rng(24)
    base = rng.integers(40, 200, (120, 160, 3), np.uint8)
    frames = [np.roll(base, 3 * i, axis=1).copy() for i in range(25)]
    mask = np.zeros((120, 160), np.uint8)
    mask[100:110, 40:120] = 255
    single = sttn_auto.STTNAutoInpainter(config=cfg, input_size=(64, 48), device="cpu")
    want = single([f.copy() for f in frames], mask)
    assert single._mesh() is None
    sharded = sttn_auto.STTNAutoInpainter(config=cfg, input_size=(64, 48), device="cpu")
    monkeypatch.setattr(sttn_auto, "default_inference_mesh", lambda device: [CPU, CPU])
    got = sharded([f.copy() for f in frames], mask)
    assert sharded._mesh() == [sharded.model] * 2
    assert all(e.mesh == [sharded.model] * 2 for e in sharded._engines.values())
    _diff_ok(np.stack(want), np.stack(got))


# ---- LaMa band path ----


@pytest.fixture(scope="module")
def lama_ckpt(tmp_path_factory):
    from vsr_tpu.models.lama import LamaGenerator as FlaxLama

    variables = _variables(FlaxLama(**TINY_LAMA), 3, jnp.zeros((1, 64, 64, 3)),
                           jnp.zeros((1, 64, 64, 1)))
    path = str(tmp_path_factory.mktemp("lama") / "lama.npz")
    save_params(path, variables)
    return path


def _lama_frames():
    rng = np.random.default_rng(32)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(9)]
    mask = np.zeros((96, 128), np.uint8)
    mask[80:92, 20:110] = 255
    return frames, mask


@pytest.fixture
def tiny_lama(monkeypatch):
    from vsr_tpu_torch.inpaint import lama as tmod
    from vsr_tpu_torch.models.lama import LamaGenerator

    monkeypatch.setattr(tmod, "LamaGenerator", lambda **kw: LamaGenerator(**kw, **TINY_LAMA))
    monkeypatch.setattr(tmod, "BAND_BATCH", 6)  # 9 frames: a batch and a padded tail
    return tmod


@pytest.mark.parametrize("n_dev", [2, 4])
def test_lama_sharded_band_batch_matches_single_device(tiny_lama, lama_ckpt, n_dev):
    """Batches of 6 (four devices: rounded up to 8, shares of 2)."""
    cfg = Config(compute_dtype="float32")
    frames, mask = _lama_frames()
    single = tiny_lama.LamaInpainter(lama_ckpt, cfg, device="cpu")
    sharded = tiny_lama.LamaInpainter(lama_ckpt, cfg, device="cpu", mesh=["cpu"] * n_dev)
    assert sharded.replicas == [sharded.model] * n_dev
    a = single([f.copy() for f in frames], mask)
    b = sharded([f.copy() for f in frames], mask)
    hole = mask > 0
    for src, fa, fb in zip(frames, a, b):
        np.testing.assert_array_equal(fb[~hole], src[~hole])
        _diff_ok(fa, fb, frac=0.05)
    assert np.abs(np.stack(b).astype(int) - np.stack(frames))[:, hole].mean() > 1


def test_lama_sharded_matches_vsr_tpu_mesh(tiny_lama, lama_ckpt, cpu_mesh, monkeypatch):
    """The port's four-replica band path against vsr_tpu's on its cpu_mesh
    (batches of 6 rounded up to 8 on both), vsr_tpu under its exact-BGR,
    mod-8 settings."""
    from vsr_tpu.config import Config as JaxConfig
    from vsr_tpu.inpaint import lama as jmod
    from vsr_tpu.models.lama import LamaGenerator as FlaxLama

    for var in ("VSR_LAMA_H2D", "VSR_LAMA_BAND_D2H"):
        monkeypatch.setenv(var, "bgr")
    monkeypatch.setenv("VSR_LAMA_BUCKET", "8")
    monkeypatch.setenv("VSR_LAMA_BAND_BATCH", "6")
    monkeypatch.setattr(jmod, "LamaGenerator", lambda **kw: FlaxLama(**{**kw, **TINY_LAMA}))
    frames, mask = _lama_frames()
    want = jmod.LamaInpainter(lama_ckpt, JaxConfig(compute_dtype="float32"), mesh=cpu_mesh)(
        [f.copy() for f in frames], mask)
    got = tiny_lama.LamaInpainter(lama_ckpt, Config(compute_dtype="float32"), device="cpu",
                                  mesh=["cpu"] * 4)([f.copy() for f in frames], mask)
    _diff_ok(np.stack(want), np.stack(got), frac=1.0)


# ---- ProPainter window sweep ----


@pytest.mark.parametrize("n_dev", [2, 3])
def test_propainter_sharded_window_sweep_matches_single_device(n_dev):
    """12 frames: windows at 0, 5 and 10 in groups of n_dev (the last group
    short with two devices), composited in window order."""
    from vsr_tpu_torch.inpaint.propainter import PropainterInpainter

    cfg = Config(compute_dtype="float32")
    cfg.propainter_raft_iters = 2
    kw = dict(config=cfg, device="cpu",
              generator_kwargs=dict(channel=16, hidden=32, depths=1, n_head=2,
                                    window_size=(3, 4), pool_size=(2, 2)),
              raft_kwargs=dict(corr_levels=2, corr_radius=2))
    rng = np.random.default_rng(31)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(12)]
    mask = np.zeros((48, 64), np.uint8)
    mask[16:32, 16:48] = 255

    single = PropainterInpainter(**kw)
    sharded = PropainterInpainter(mesh=["cpu"] * n_dev, **kw)
    for a, b in zip(single.generator.state_dict().values(),
                    sharded.generator.state_dict().values()):
        assert torch.equal(a, b)  # the same seeded weights
    assert sharded.replicas == [sharded.generator] * n_dev
    a = single.inpaint([f.copy() for f in frames], mask)
    b = sharded.inpaint([f.copy() for f in frames], mask)
    for fa, fb in zip(a, b):
        _diff_ok(fa, fb)
