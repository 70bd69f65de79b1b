"""The port's reference-checkpoint converters (vsr_tpu_torch/convert/)
against the JAX package's, bit for bit: the same synthetic reference state
dict, in the reference's key layout, goes through both, and the flattened
trees must have the same keys in the same order, the same dtypes and equal
leaves. Then the loaders: a reference .pth loads into the port's module
exactly as the JAX package's converter followed by from_flax, and as the
.npz route (ROADMAP.md F3)."""

import sys

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests.reference_compat import build_torch_lama
from tests.test_convert import synthetic_torch_state_dict
from tests.test_convert_propainter import (
    build_flow_completion_state_dict,
    build_generator_state_dict,
)
from tests.test_convert_raft import build_raft_things_state_dict
from vsr_tpu.convert import mapping as jax_mapping
from vsr_tpu.convert import paddle_dbnet as jax_dbnet
from vsr_tpu.convert import params_io as jax_io
from vsr_tpu.convert import torch_lama as jax_lama
from vsr_tpu.convert import torch_propainter as jax_pp
from vsr_tpu.convert import torch_raft as jax_raft
from vsr_tpu.convert import torch_sttn as jax_sttn
from vsr_tpu_torch.convert import mapping, paddle_dbnet, params_io, torch_lama
from vsr_tpu_torch.convert import torch_propainter, torch_raft, torch_sttn

STTN_TINY = dict(channel=16, stack_num=2, patchsizes_override=((4, 3), (2, 2)))
GEN_TINY = dict(channel=16, hidden=32, depths=2)
# big-lama's structure (3 downsamples, the 18 blocks the converter's indices
# are written for) at a quarter of its width
LAMA_NARROW = dict(ngf=16, n_blocks=18)


def assert_same_tree(want, got):
    """want: the JAX package's tree (jax leaves); got: the port's (numpy)."""
    flat_w = traverse_util.flatten_dict(want, sep="/")
    flat_g = mapping.flatten_tree(got)
    assert list(flat_g) == list(flat_w)
    for key, leaf in flat_w.items():
        leaf = np.asarray(leaf)
        assert isinstance(flat_g[key], np.ndarray), key
        assert flat_g[key].dtype == leaf.dtype, key
        assert np.array_equal(flat_g[key], leaf), key


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _paddle_state_dict(preset, prune_thresh, seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in jax_dbnet.paddle_state_spec(preset).items():
        if prune_thresh and key.startswith("head.thresh."):
            continue
        if key.endswith("._variance"):
            sd[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[key] = rng.normal(0, 0.05, shape).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def lama_files(tmp_path_factory):
    """A narrow big-lama as a TorchScript blob (what the reference ships)
    and as a raw .pth under 'state_dict' with 'generator.' prefixes."""
    d = tmp_path_factory.mktemp("lama")
    torch.manual_seed(0)
    model = build_torch_lama(**LAMA_NARROW).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 1.5)
        traced = torch.jit.trace(model, torch.zeros(1, 4, 64, 64), check_trace=False)
    blob = str(d / "big-lama.pt")
    traced.save(blob)
    raw = str(d / "big-lama-raw.pth")
    torch.save({"state_dict": {f"generator.{k}": v for k, v in model.state_dict().items()}},
               raw)
    return {"torchscript": blob, "raw": raw}


# family -> (the JAX package's converter, the port's), each taking a state dict
STATE_DICT_CASES = {
    "sttn": (lambda: _tensors(synthetic_torch_state_dict(channel=16, stack=2)),
             jax_sttn.convert_sttn_state_dict, torch_sttn.convert_sttn_state_dict),
    # float64 values: jnp.asarray narrows them to float32 (x64 off), so must the port
    "sttn-float64": (lambda: {k: v.astype(np.float64) for k, v in
                              synthetic_torch_state_dict(channel=16, stack=2).items()},
                     jax_sttn.convert_sttn_state_dict, torch_sttn.convert_sttn_state_dict),
    "raft-module-prefix": (lambda: _tensors(build_raft_things_state_dict()),
                           jax_raft.convert_raft_state_dict, torch_raft.convert_raft_state_dict),
    "raft-bare": (lambda: {k[len("module."):]: v for k, v in
                           build_raft_things_state_dict().items()},
                  jax_raft.convert_raft_state_dict, torch_raft.convert_raft_state_dict),
    "propainter": (lambda: _tensors(build_generator_state_dict(**GEN_TINY)),
                   jax_pp.convert_propainter_generator,
                   torch_propainter.convert_propainter_generator),
    "flow-completion": (lambda: _tensors(build_flow_completion_state_dict()),
                        jax_pp.convert_flow_completion, torch_propainter.convert_flow_completion),
    "dbnet-server": (lambda: _paddle_state_dict("server", False),
                     lambda sd: jax_dbnet.convert_paddle_det_state_dict(sd, "server"),
                     lambda sd: paddle_dbnet.convert_paddle_det_state_dict(sd, "server")),
    "dbnet-mobile": (lambda: _paddle_state_dict("mobile", False),
                     lambda sd: jax_dbnet.convert_paddle_det_state_dict(sd, "mobile"),
                     lambda sd: paddle_dbnet.convert_paddle_det_state_dict(sd, "mobile")),
    "dbnet-server-pruned": (lambda: _paddle_state_dict("server", True),
                            lambda sd: jax_dbnet.convert_paddle_det_state_dict(sd, "server"),
                            lambda sd: paddle_dbnet.convert_paddle_det_state_dict(sd, "server")),
    "dbnet-mobile-pruned": (lambda: _paddle_state_dict("mobile", True),
                            lambda sd: jax_dbnet.convert_paddle_det_state_dict(sd, "mobile"),
                            lambda sd: paddle_dbnet.convert_paddle_det_state_dict(sd, "mobile")),
}


@pytest.mark.parametrize("case", sorted(STATE_DICT_CASES))
def test_converter_bit_identical(case):
    build, jax_convert, port_convert = STATE_DICT_CASES[case]
    sd = build()
    assert_same_tree(jax_convert(sd), port_convert(sd))


@pytest.mark.parametrize("kind", ["torchscript", "raw"])
def test_lama_checkpoint_bit_identical(kind, lama_files):
    """load_lama_checkpoint: TorchScript first, then a raw .pth with its
    'generator.' prefix stripped; both packages give the same tree."""
    path = lama_files[kind]
    assert_same_tree(jax_lama.load_lama_checkpoint(path), torch_lama.load_lama_checkpoint(path))


@pytest.mark.parametrize("key", ["model.5.conv1.ffc.convl2l.weight", "generator.model.7.weight",
                                 "model.34.bias"])
def test_lama_normalize_key(key):
    assert torch_lama._normalize_key(key) == jax_lama._normalize_key(key)


@pytest.mark.parametrize("preset", ["server", "mobile"])
def test_paddle_spec_and_validation(preset):
    """The Paddle program and validate_state_dict's findings are the JAX
    package's, from the port's own stage tables; synthesize_thresh_defaults
    fills the same branch."""
    assert paddle_dbnet.paddle_state_spec(preset) == jax_dbnet.paddle_state_spec(preset)
    sd = _paddle_state_dict(preset, True)
    sd["backbone.bogus.weight"] = np.zeros((2,), np.float32)
    key = "head.binarize.conv1.weight"
    sd[key] = sd[key][..., :1]
    problems = paddle_dbnet.validate_state_dict(sd, preset)
    assert problems == jax_dbnet.validate_state_dict(sd, preset) and len(problems) == 2
    filled = paddle_dbnet.synthesize_thresh_defaults(_paddle_state_dict(preset, True), preset)
    want = jax_dbnet.synthesize_thresh_defaults(_paddle_state_dict(preset, True), preset)
    assert list(filled) == list(want)
    for k in want:
        assert filled[k].dtype == want[k].dtype and np.array_equal(filled[k], want[k]), k


@pytest.mark.parametrize("case", ["mapping", "sttn", "raft", "dbnet"])
def test_unknown_key_raises_in_both(case):
    if case == "sttn":
        sd = synthetic_torch_state_dict(channel=16, stack=2)
        sd["transformer.0.attention.bogus.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        converters = (jax_sttn.convert_sttn_state_dict, torch_sttn.convert_sttn_state_dict)
    elif case == "raft":
        sd = build_raft_things_state_dict()
        sd["module.update_block.bogus.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        converters = (jax_raft.convert_raft_state_dict, torch_raft.convert_raft_state_dict)
    elif case == "dbnet":
        sd = _paddle_state_dict("mobile", False)
        sd["backbone.bogus_layer.weight"] = np.zeros((3, 3), np.float32)
        converters = (lambda s: jax_dbnet.convert_paddle_det_state_dict(s, "mobile"),
                      lambda s: paddle_dbnet.convert_paddle_det_state_dict(s, "mobile"))
    else:
        sd = {"a.weight": np.zeros((2, 2), np.float32), "b.weight": np.ones((2,), np.float32)}
        rules = [(r"a", "a", "linear")]
        with pytest.raises(KeyError, match="unmapped checkpoint keys"):
            mapping.convert_state_dict(sd, rules)
        assert_same_tree(jax_mapping.convert_state_dict(sd, rules, strict=False),
                         mapping.convert_state_dict(sd, rules, strict=False))
        converters = (lambda s: jax_mapping.convert_state_dict(s, rules),
                      lambda s: mapping.convert_state_dict(s, rules))
    for convert in converters:
        with pytest.raises(KeyError):
            convert(sd)


def test_validate_against_matches():
    """Missing, extra and misshapen leaves are reported as vsr_tpu reports
    them."""
    full = torch_sttn.convert_sttn_state_dict(synthetic_torch_state_dict(channel=16, stack=2))
    sd = synthetic_torch_state_dict(channel=16, stack=1)
    sd["decoder.6.bias"] = sd["decoder.6.bias"][:2]
    part = torch_sttn.convert_sttn_state_dict(sd)
    for a, b in ((part, full), (full, part)):
        problems = mapping.validate_against(a, b)
        assert problems == jax_mapping.validate_against(a, b)
        assert any(p.startswith("shape ") for p in problems)
    assert mapping.validate_against(full, full) == []


def test_load_pdiparams_raises_without_paddle(tmp_path, monkeypatch):
    """Without the paddle package (absent here and on the card's machine)
    both packages' load_pdiparams raise, naming paddle."""
    monkeypatch.setitem(sys.modules, "paddle", None)
    path = str(tmp_path / "inference.pdiparams")
    for load in (jax_dbnet.load_pdiparams, paddle_dbnet.load_pdiparams):
        with pytest.raises(ImportError, match="Paddle is required"):
            load(path)


def test_params_io_interchange(tmp_path):
    """An .npz written by either package loads in the other to the same
    tree (save_params / load_params)."""
    variables = torch_raft.convert_raft_state_dict(build_raft_things_state_dict())
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    params_io.save_params(port_npz, variables)
    jax_io.save_params(jax_npz, jax_raft.convert_raft_state_dict(build_raft_things_state_dict()))
    assert_same_tree(jax_io.load_params(port_npz), params_io.load_params(jax_npz))
    assert_same_tree(jax_io.load_params(jax_npz), params_io.load_params(port_npz))
    with np.load(port_npz) as a, np.load(jax_npz) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _training_state_dicts():
    """family -> a synthetic reference checkpoint of the training and metric
    families, in the reference's key layout: i3d_rgb_imagenet.pt (its 1x1x1
    logits conv included), torchvision vgg16 / vgg19 (a classifier key the
    converter drops) and the lpips package's vgg.pth (its scaling_layer
    buffers, dropped)."""
    from tests.test_perceptual import TorchLPIPS, build_torch_vgg_features
    from tests.test_torch_i3d import reference_state_dict

    torch.manual_seed(0)
    out = {"i3d": reference_state_dict()}
    for vgg_type in ("vgg16", "vgg19"):
        sd = {f"features.{k}": v for k, v in build_torch_vgg_features(vgg_type).state_dict().items()}
        sd["classifier.0.weight"] = torch.zeros(4, 8)
        out[vgg_type] = sd
    out["lpips"] = TorchLPIPS().state_dict()
    return out


@pytest.mark.parametrize("family", ["i3d", "vgg16", "vgg19", "lpips"])
def test_training_family_converters_match(family):
    """convert/torch_{i3d,vgg,lpips}.py against vsr_tpu's, bit for bit."""
    from vsr_tpu.convert import torch_i3d as jax_i3d
    from vsr_tpu.convert import torch_lpips as jax_lpips
    from vsr_tpu.convert import torch_vgg as jax_vgg
    from vsr_tpu_torch.convert import torch_i3d, torch_lpips, torch_vgg

    sd = _training_state_dicts()[family]
    if family == "i3d":
        want, got = jax_i3d.convert_i3d_state_dict(sd), torch_i3d.convert_i3d_state_dict(sd)
        assert got["params"]["logits"]["kernel"].shape == (1024, 400)
    elif family == "lpips":
        want, got = jax_lpips.convert_lpips_state_dict(sd), torch_lpips.convert_lpips_state_dict(sd)
    else:
        want = jax_vgg.convert_vgg_state_dict(sd, family)
        got = torch_vgg.convert_vgg_state_dict(sd, family)
    assert_same_tree(want, got)


def test_convert_cli_matches(tmp_path):
    """python -m vsr_tpu_torch.convert writes what python -m vsr_tpu.convert
    writes: raft, and the training and metric families (i3d, vgg16, vgg19,
    lpips), which the port's CLI refused until it had their converters."""
    from vsr_tpu.convert.__main__ import main as jax_main
    from vsr_tpu_torch.convert.__main__ import main

    checkpoints = {"raft": _tensors(build_raft_things_state_dict()), **_training_state_dicts()}
    for family, sd in checkpoints.items():
        pth = str(tmp_path / f"{family}.pth")
        torch.save(sd, pth)
        ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
        assert main([family, pth, "-o", ours]) == 0
        assert jax_main([family, pth, "-o", theirs]) == 0
        with np.load(ours) as a, np.load(theirs) as b:
            assert a.files == b.files, family
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (family, k)


# ---- the loaders: reference checkpoints given as paths (ROADMAP.md F3) ----


def _reference_files(d):
    """family -> (reference checkpoint path, the port's module, its loader,
    the JAX package's torch_converter for the path, from_flax map)."""
    from vsr_tpu.convert.torch_raft import load_raft_checkpoint
    from vsr_tpu.convert.torch_sttn import load_sttn_checkpoint
    from vsr_tpu_torch.convert import from_flax
    from vsr_tpu_torch.inpaint import weights
    from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet
    from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
    from vsr_tpu_torch.models.propainter.raft import RAFT
    from vsr_tpu_torch.models.sttn import STTNGenerator

    def torch_loader(convert):  # vsr_tpu/inpaint/propainter.py's
        return lambda path: convert(torch.load(path, map_location="cpu"))

    files = {
        "sttn": ("infer_model.pth", {"netG": _tensors(synthetic_torch_state_dict(16, 2))},
                 lambda: STTNGenerator(variant="auto", **STTN_TINY), weights.load_sttn_weights,
                 load_sttn_checkpoint, from_flax.sttn_state_dict_from_flax),
        "raft": ("raft-things.pth", _tensors(build_raft_things_state_dict()), RAFT,
                 weights.load_raft_weights, load_raft_checkpoint,
                 from_flax.raft_state_dict_from_flax),
        "flow-completion": ("recurrent_flow_completion.pth",
                            _tensors(build_flow_completion_state_dict()),
                            lambda: RecurrentFlowCompleteNet(edge_head=True),
                            weights.load_flow_completion_weights,
                            torch_loader(jax_pp.convert_flow_completion),
                            from_flax.flow_completion_state_dict_from_flax),
        # full width: the port's encoder scales with ``channel``, the
        # reference layout's does not
        "propainter": ("ProPainter.pth", _tensors(build_generator_state_dict()),
                       ProPainterGenerator, weights.load_propainter_weights,
                       torch_loader(jax_pp.convert_propainter_generator),
                       from_flax.propainter_state_dict_from_flax),
    }
    out = {}
    for family, (name, ckpt, *rest) in files.items():
        path = str(d / name)
        torch.save(ckpt, path)
        out[family] = (path, *rest)
    return out


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    return _reference_files(tmp_path_factory.mktemp("reference"))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("family", ["sttn", "raft", "flow-completion", "propainter"])
def test_reference_checkpoint_loads_as_in_vsr_tpu(family, reference_files):
    """F3: the port raised on raft-things.pth, recurrent_flow_completion.pth
    and ProPainter.pth given as checkpoint paths, which vsr_tpu loads
    through its torch converters. Now both packages load them to the same
    parameters: vsr_tpu's load_or_init_params (with the converter its
    inpainter passes) followed by from_flax equals the port's load."""
    from vsr_tpu.inpaint.weights import load_or_init_params

    path, make, load, jax_converter, from_flax = reference_files[family]
    want = from_flax(load_or_init_params(None, (), path, torch_converter=jax_converter))
    model = make()
    load(model, path)
    got = _state(model)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("family", ["sttn", "raft", "flow-completion", "propainter"])
def test_pth_route_equals_npz_route(family, reference_files, tmp_path):
    """load_*_weights(model, x.pth) gives the state dict that the .npz the
    converter writes gives, bit for bit."""
    path, make, load, _, _ = reference_files[family]
    name = {"sttn": "sttn-auto"}.get(family, family)
    from vsr_tpu_torch.convert.__main__ import _load

    npz = str(tmp_path / "x.npz")
    params_io.save_params(npz, _load(name, path))
    via_pth, via_npz = make(), make()
    load(via_pth, path)
    load(via_npz, npz)
    a, b = _state(via_pth), _state(via_npz)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("family", ["lama", "dbnet"])
def test_lama_and_dbnet_reference_files_raise(family, tmp_path):
    """As in vsr_tpu, a big-lama.pt or a DBNet .pth given as a checkpoint
    path raises: those reach the port through --prepare-models."""
    from vsr_tpu_torch.detect.dbnet import DBNet
    from vsr_tpu_torch.inpaint import weights
    from vsr_tpu_torch.models.lama import LamaGenerator

    path = tmp_path / "ckpt.pt"
    path.write_bytes(b"")
    model, load = ((LamaGenerator(ngf=8, n_downsampling=2, n_blocks=1), weights.load_lama_weights)
                   if family == "lama" else (DBNet("mobile"), weights.load_dbnet_weights))
    with pytest.raises(ValueError, match="--prepare-models"):
        load(model, str(path))


def test_chip_smoke_reference_tree_layout():
    """chip_smoke.py writes its full-width reference tree from its own key
    -> shape tables (it imports no test module); they list exactly the keys
    and shapes of the state dicts the converter tests build."""
    import chip_smoke
    from tests.test_torch_i3d import i3d_reference_shapes

    specs = chip_smoke.reference_specs()
    want = {
        "sttn": {k: v.shape for k, v in synthetic_torch_state_dict().items()},
        "raft": {k: v.shape for k, v in build_raft_things_state_dict().items()},
        "flow_completion": {k: v.shape for k, v in build_flow_completion_state_dict().items()},
        "propainter": {k: v.shape for k, v in build_generator_state_dict().items()},
        "lama": {k: tuple(v.shape) for k, v in build_torch_lama().state_dict().items()},
        "i3d": i3d_reference_shapes(),
    }
    assert set(specs) == set(want)
    for family, spec in want.items():
        assert {k: tuple(s) for k, s in specs[family].items()} == \
            {k: tuple(s) for k, s in spec.items()}, family
