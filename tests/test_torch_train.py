"""The port's STTN training (vsr_tpu_torch/train/, models/discriminator.py)
against the JAX package's on the CPU, from the same flax variables:

* the GAN and masked L1 losses, the learning-rate schedules (and LambdaLR
  giving the k-th update the rate at k, as optax does);
* the spectral-norm video discriminator layer by layer, and its stored u
  and sigma after an update_stats=True pass and after a False pass, within
  1e-5;
* two STTN trainer steps against ``make_train_step`` at the tiny config of
  tests/test_train.py (det, channel 16, one block, TINY_PATCHES, 32x24,
  L = 2, B = 2): every metric within 1e-4 relative, every parameter and
  spectral-norm statistic within 2e-6 absolute;
* the checkpoint round trip with exact resume, ``evaluate``, ``train`` with
  scalars, the train_sttn CLI on a synthetic zip dataset, and the
  forward-only guard of the token-attention kernel (F6).

The JAX steps run once per module (a fixture): its jit compile dominates.
Parameters are drawn with numpy (every bias non-zero): at flax's zero bias
init, the masked hole feeds exact zeros into LeakyReLU, whose derivative
at 0 is 1 in flax and the slope in torch (and the reference), so the first
step would differ there by design (ROADMAP "Deliberate divergences").
"""

import functools
import json
import os
import types
import zipfile

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from vsr_tpu.models.discriminator import VideoDiscriminator as FlaxDiscriminator
from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
from vsr_tpu.train import losses as jax_losses
from vsr_tpu.train import lr_schedulers as jax_lrs
from vsr_tpu.train import sttn_trainer as jax_trainer
from vsr_tpu_torch.convert.from_flax import (
    discriminator_state_dict_from_flax,
    sttn_state_dict_from_flax,
)
from vsr_tpu_torch.models.discriminator import VideoDiscriminator
from vsr_tpu_torch.models.sttn import STTNGenerator
from vsr_tpu_torch.ops import token_attention as ta
from vsr_tpu_torch.train import losses, lr_schedulers, sttn_trainer, train_sttn
from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig

TINY_PATCHES = ((4, 3), (2, 2))
TINY_CFG = dict(frame_w=32, frame_h=24, sample_length=2, batch_size=2, save_freq=10 ** 9)
METRIC_RTOL = 1e-4
PARAM_ATOL = 2e-6
SN_ATOL = 1e-5


def draw_params(shapes, seed):
    """A flax params tree (shapes from jax.eval_shape) from a seed: LeCun
    normal kernels, every other leaf N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(shapes, sep="/")
    for k, a in flat.items():
        if k.endswith("kernel"):
            flat[k] = rng.normal(0, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        else:
            flat[k] = rng.normal(0, 0.1, a.shape)
        flat[k] = flat[k].astype(np.float32)
    return traverse_util.unflatten_dict(flat, sep="/")


def draw_discriminator(module, seed, *init_args):
    """(params, batch_stats) of a flax VideoDiscriminator: params as
    draw_params, u normal, sigma 1. The statistics' names hold '/'
    (``conv0/kernel/u``), so they are mapped, not flattened."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    rng = np.random.default_rng(seed + 1000)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.normal(0, 1, a.shape) if a.shape else np.ones(())).astype(np.float32),
        shapes["batch_stats"])
    return draw_params(shapes["params"], seed), stats


def port_discriminator(params, stats, nf=8):
    model = VideoDiscriminator(nf=nf)
    model.load_state_dict(discriminator_state_dict_from_flax(params, stats), strict=True)
    return model


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def fake_batch(seed, batch=2, length=2, h=24, w=32):
    """tests/test_train.py's batch: uniform frames, a fixed hole."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (batch, length, h, w, 3)).astype(np.float32)
    masks = np.zeros((batch, length, h, w, 1), np.float32)
    masks[:, :, 8:16, 8:24] = 1.0
    return frames, masks


def tiny_generator():
    return STTNGenerator(variant="det", channel=16, stack_num=1,
                         patchsizes_override=TINY_PATCHES, use_kernel=False)


@pytest.fixture(scope="module")
def sttn_run():
    """Two JAX train steps from drawn variables: the start and end state."""
    cfg = jax_trainer.TrainConfig(**TINY_CFG)
    fg = FlaxSTTN(variant="det", channel=16, stack_num=1, patchsizes_override=TINY_PATCHES)
    fd = FlaxDiscriminator(nf=8)
    frames0, masks0 = fake_batch(0)
    gen_params = draw_params(jax.eval_shape(fg.init, jax.random.PRNGKey(0), frames0, masks0), 1)
    dis_params, stats = draw_discriminator(fd, 2, frames0)
    opt = jax_trainer.make_optimizer(cfg)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen_params, gen_opt=opt.init(gen_params),
        dis_params=dis_params, dis_vars={"batch_stats": stats}, dis_opt=opt.init(dis_params))
    step = jax_trainer.make_train_step(fg, fd, cfg)
    metrics = []
    for seed in range(2):
        state, m = step(state, *map(jnp.asarray, fake_batch(seed)))
        metrics.append({k: float(v) for k, v in m.items()})
    return types.SimpleNamespace(
        flax_generator=fg, gen_params=gen_params, dis_params=dis_params, stats=stats,
        metrics=metrics, final=to_np(state))


def port_trainer(run, **cfg):
    gen = tiny_generator()
    gen.load_state_dict(sttn_state_dict_from_flax(run.gen_params), strict=True)
    return STTNTrainer(TrainConfig(**{**TINY_CFG, **cfg}), generator=gen,
                       discriminator=port_discriminator(run.dis_params, run.stats),
                       device="cpu")


# ---- losses and schedules ----


@pytest.mark.parametrize("gan_type", ["hinge", "nsgan", "lsgan"])
@pytest.mark.parametrize("is_real", [True, False])
@pytest.mark.parametrize("is_disc", [True, False])
def test_adversarial_loss_matches(gan_type, is_real, is_disc):
    rng = np.random.default_rng(3)
    out = rng.uniform(-2, 2, (2, 3, 4, 5, 6)).astype(np.float32)
    if gan_type == "nsgan":
        out = 1 / (1 + np.exp(-out))
    want = float(jax_losses.adversarial_loss(jnp.asarray(out), is_real, is_disc, gan_type))
    got = float(losses.adversarial_loss(torch.from_numpy(out), is_real, is_disc, gan_type))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_adversarial_loss_rejects_unknown():
    with pytest.raises(ValueError):
        losses.adversarial_loss(torch.zeros(2), True, True, "wgan")


def test_masked_l1_matches():
    rng = np.random.default_rng(4)
    pred, target = (rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    for mask in (np.zeros((3, 8, 8, 1), np.float32),
                 (rng.uniform(size=(3, 8, 8, 1)) > 0.7).astype(np.float32)):
        want = float(jax_losses.masked_l1(*map(jnp.asarray, (pred, target, mask))))
        got = float(losses.masked_l1(*map(torch.from_numpy, (pred, target, mask))))
        assert got == pytest.approx(want, rel=1e-6)


STEPS = list(range(0, 40)) + [99, 100, 101, 149, 150, 151, 299, 300, 301, 10_000]


@pytest.mark.parametrize("make", [
    lambda m: m.multi_step_restart_lr(1e-3, [10, 20], 0.5, restarts=[0, 25],
                                      restart_weights=[1.0, 0.3]),
    lambda m: m.multi_step_restart_lr(2e-4, [5, 150]),
    lambda m: m.cosine_annealing_restart_lr(1e-3, [15, 20], restart_weights=[1.0, 0.5]),
    lambda m: m.cosine_annealing_restart_lr(5e-4, [100], eta_min=1e-6),
], ids=["multi_step_restarts", "multi_step", "cosine_restarts", "cosine"])
def test_schedules_match(make):
    """The port computes in float64, the JAX package in float32: within
    float32's rounding of terms of the base rate's size (1e-6 of 1e-3)."""
    jax_schedule, schedule = make(jax_lrs), make(lr_schedulers)
    for step in STEPS:
        assert schedule(step) == pytest.approx(float(jax_schedule(step)), rel=1e-6, abs=1e-9), step


def test_sttn_step_decay_matches():
    kw = dict(lr=1e-4, niter=100, niter_steady=300)
    want = jax_trainer.lr_schedule(jax_trainer.TrainConfig(**kw))
    got = sttn_trainer.lr_schedule(TrainConfig(**kw))
    for step in STEPS:
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step


def test_schedules_reject_unequal_lengths():
    with pytest.raises(ValueError):
        lr_schedulers.multi_step_restart_lr(1e-3, [10], restarts=[0, 5], restart_weights=[1.0])
    with pytest.raises(ValueError):
        lr_schedulers.cosine_annealing_restart_lr(1e-3, [10, 5], restart_weights=[1.0])


def test_lambda_lr_gives_update_k_the_rate_at_k():
    """optax evaluates a schedule at the count of updates made before the
    current one; make_optimizer's LambdaLR must give the same rates."""
    schedule = lr_schedulers.multi_step_restart_lr(1e-3, [2, 4], 0.5)
    param = torch.nn.Linear(2, 2)
    opt, sched = sttn_trainer.make_optimizer(param, TrainConfig(), schedule)
    for k in range(7):
        assert opt.param_groups[0]["lr"] == schedule(k)
        opt.zero_grad()
        param(torch.ones(1, 2)).sum().backward()
        opt.step()
        sched.step()


# ---- the spectral-norm discriminator ----


@pytest.mark.parametrize("nf,shape", [(8, (2, 3, 32, 48)), (4, (1, 5, 24, 40))])
def test_discriminator_layers_and_stats_match(nf, shape):
    """Each layer's output (hooks against flax's intermediates), the final
    features, and u / sigma after an update_stats=True pass, then after a
    False pass (which iterates from the stored u and stores nothing)."""
    fd = FlaxDiscriminator(nf=nf)
    rng = np.random.default_rng(nf)
    x = rng.uniform(-1, 1, (*shape, 3)).astype(np.float32)
    params, stats = draw_discriminator(fd, nf, x)
    model = port_discriminator(params, stats, nf)
    feats = {}
    for i in range(6):
        getattr(model, f"conv{i}").register_forward_hook(
            lambda m, inp, out, i=i: feats.__setitem__(i, out.transpose(1, 2).detach().numpy()))
    tx = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2)))
    variables = {"params": params, "batch_stats": stats}
    for update in (True, False):
        out, new = fd.apply(variables, jnp.asarray(x), update_stats=update,
                            mutable=["batch_stats", "intermediates"], capture_intermediates=True)
        got = model(tx, update_stats=update).detach().numpy()
        np.testing.assert_allclose(np.moveaxis(got, 2, -1), np.asarray(out), rtol=1e-5, atol=1e-5)
        for i in range(5):
            want = np.asarray(new["intermediates"][f"SpectralNorm_{i}"]["__call__"][0])
            np.testing.assert_allclose(np.moveaxis(feats[i], 2, -1), want, rtol=1e-5, atol=1e-5)
        want5 = np.asarray(new["intermediates"]["conv5"]["__call__"][0])
        np.testing.assert_allclose(np.moveaxis(feats[5], 2, -1), want5, rtol=1e-5, atol=1e-5)
        variables = {"params": params, "batch_stats": new["batch_stats"]}
        buffers = model.state_dict()
        for i in range(5):
            leaf = new["batch_stats"][f"SpectralNorm_{i}"]
            np.testing.assert_allclose(buffers[f"conv{i}.u"].numpy(),
                                       np.asarray(leaf[f"conv{i}/kernel/u"]), atol=SN_ATOL)
            np.testing.assert_allclose(float(buffers[f"conv{i}.sigma"]),
                                       float(leaf[f"conv{i}/kernel/sigma"]), atol=SN_ATOL)
    # the False pass stored nothing: sigma still the True pass's, not 1
    assert all(float(model.state_dict()[f"conv{i}.sigma"]) != 1.0 for i in range(5))


def test_discriminator_sigma_keeps_its_gradient():
    """sigma = v W u^T with u and v detached: the gradient of a loss through
    the normalised kernel W / sigma equals flax's."""
    fd = FlaxDiscriminator(nf=4)
    x = np.random.default_rng(9).uniform(-1, 1, (1, 3, 24, 32, 3)).astype(np.float32)
    params, stats = draw_discriminator(fd, 9, x)

    def loss(p):
        return jnp.mean(fd.apply({"params": p, "batch_stats": stats}, jnp.asarray(x)) ** 2)

    want = jax.grad(loss)(params)
    model = port_discriminator(params, stats, 4)
    (model(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2)))) ** 2).mean().backward()
    want_state = discriminator_state_dict_from_flax(to_np(want))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-7)


def test_discriminator_converter_rejects_unknown_keys():
    with pytest.raises(KeyError):
        discriminator_state_dict_from_flax({"conv6": {"kernel": np.zeros((1, 1, 1, 1, 1))}})
    with pytest.raises(KeyError):
        discriminator_state_dict_from_flax(
            {}, {"SpectralNorm_0": {"conv1/kernel/u": np.zeros((1, 4))}})


# ---- the trainer against make_train_step ----


def test_two_steps_match_jax(sttn_run):
    trainer = port_trainer(sttn_run)
    for seed, want in enumerate(sttn_run.metrics):
        got = sttn_trainer.as_floats(trainer.step(*fake_batch(seed)))
        assert set(got) == set(want) == set(sttn_trainer.METRICS)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), k
    final = sttn_run.final
    gen_want = sttn_state_dict_from_flax(final.gen_params)
    for k, v in trainer.generator.state_dict().items():
        np.testing.assert_allclose(v.numpy(), gen_want[k].numpy(), atol=PARAM_ATOL, err_msg=k)
    dis_want = discriminator_state_dict_from_flax(final.dis_params,
                                                  final.dis_vars["batch_stats"])
    for k, v in trainer.discriminator.state_dict().items():
        atol = SN_ATOL if k.endswith((".u", ".sigma")) else PARAM_ATOL
        np.testing.assert_allclose(v.numpy(), dis_want[k].numpy(), atol=atol, err_msg=k)
    assert trainer.step_count == 2
    assert trainer.gen_opt.param_groups[0]["lr"] == pytest.approx(1e-4)


def test_clip_forward_matches_jax(sttn_run):
    """STTNGenerator.forward (encode, transform with the det variant's
    1/4-scale hole mask, decode) against the flax __call__."""
    frames, masks = fake_batch(6)
    masked = frames * (1 - masks)
    want = jax.jit(sttn_run.flax_generator.apply)(sttn_run.gen_params, masked, masks)
    gen = tiny_generator()
    gen.load_state_dict(sttn_state_dict_from_flax(sttn_run.gen_params), strict=True)
    got = gen(torch.from_numpy(masked), torch.from_numpy(masks))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_evaluate_matches_jax(sttn_run):
    frames, masks = fake_batch(5)
    jax_self = types.SimpleNamespace(generator=sttn_run.flax_generator,
                                     state=types.SimpleNamespace(gen_params=sttn_run.gen_params))
    want = jax_trainer.STTNTrainer.evaluate(jax_self, frames, masks)
    got = port_trainer(sttn_run).evaluate(frames, masks)
    assert set(got) == {"psnr", "ssim"}
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-3)
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-3)


def test_checkpoint_round_trip_resumes_exactly(sttn_run, tmp_path):
    trainer = port_trainer(sttn_run, save_dir=str(tmp_path))
    trainer.step(*fake_batch(0))
    path = trainer.save()
    assert os.path.basename(path) == "ckpt_1.pt"
    cont = sttn_trainer.as_floats(trainer.step(*fake_batch(1)))

    other = STTNTrainer(TrainConfig(**TINY_CFG), generator=tiny_generator(),
                        discriminator=VideoDiscriminator(nf=8, seed=5), device="cpu")
    other.restore(path)
    assert other.step_count == 1
    assert other.gen_sched.last_epoch == 1
    again = sttn_trainer.as_floats(other.step(*fake_batch(1)))
    assert again == cont
    for a, b in ((trainer.generator, other.generator),
                 (trainer.discriminator, other.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k


def test_train_writes_scalars_logs_and_checkpoints(sttn_run, tmp_path, monkeypatch):
    """JSONL scalars (the contract; the tensorboard mirror is left out: its
    import loads tensorflow, ~15 s), log_cb at log_freq, a checkpoint at
    save_freq."""
    from vsr_tpu_torch.train import scalars

    monkeypatch.setattr(scalars, "_tb_writer", lambda log_dir: None)
    summary = tmp_path / "summary"
    trainer = port_trainer(sttn_run, save_dir=str(tmp_path), summary_dir=str(summary),
                           log_freq=1, save_freq=2)
    logged = []
    batches = (fake_batch(s) for s in range(10))
    metrics = trainer.train(batches, 3, log_cb=lambda step, m: logged.append((step, m)))
    assert [s for s, _ in logged] == [1, 2, 3]
    assert metrics == logged[-1][1] and all(np.isfinite(v) for v in metrics.values())
    assert os.path.exists(tmp_path / "ckpt_2.pt") and not os.path.exists(tmp_path / "ckpt_3.pt")
    lines = [json.loads(line) for line in open(summary / "scalars.jsonl")]
    assert [(l["step"], l["tag"]) for l in lines] == [
        (s, f"loss/{k}") for s in (1, 2, 3) for k in sttn_trainer.METRICS]
    assert lines[-1]["value"] == pytest.approx(metrics["valid_loss"])


def test_default_trainer_uses_the_plain_attention_route():
    """The kernel is forward-only, so the default generator is built with
    use_kernel=False: every block's attention takes the plain route."""
    trainer = STTNTrainer(device="cpu")
    gen = trainer.generator
    assert gen.variant == "auto" and len(gen.transformer) == 8
    assert not any(block.attention.use_kernel for block in gen.transformer)
    assert trainer.discriminator.conv5.out_channels == 256
    assert not trainer.discriminator.use_sigmoid
    assert STTNTrainer(TrainConfig(gan_loss="nsgan"), generator=tiny_generator(),
                       device="cpu").discriminator.use_sigmoid


def test_mesh_raises_naming_the_roadmap_item():
    """Training across processes is ported (tests/test_torch_distributed.py):
    a trainer's mesh is a TrainingMesh of process groups, and an inference
    mesh (a list of devices) raises naming it."""
    with pytest.raises(TypeError, match="TrainingMesh"):
        STTNTrainer(generator=tiny_generator(), discriminator=VideoDiscriminator(nf=4),
                    device="cpu", mesh=[torch.device("cpu")] * 2)


# ---- the train_sttn CLI ----


def make_zip_videos(root, n=2, frames=6):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(3)
    for v in range(n):
        with zipfile.ZipFile(os.path.join(root, f"vid{v}.zip"), "w") as zf:
            for i in range(frames):
                ok, buf = cv2.imencode(".jpg", rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
                zf.writestr(f"{i:05d}.jpg", buf.tobytes())
    return str(root)


@pytest.fixture
def tiny_cli_models(monkeypatch):
    """The CLI's default networks at test width (sttn-auto keeps its
    640x120 geometry: its patch sizes need it)."""
    monkeypatch.setattr(sttn_trainer, "STTNGenerator",
                        functools.partial(STTNGenerator, channel=16, stack_num=1))
    monkeypatch.setattr(sttn_trainer, "VideoDiscriminator",
                        functools.partial(VideoDiscriminator, nf=4))


def test_train_sttn_cli_trains_saves_and_resumes(tmp_path, tiny_cli_models, capsys):
    data = make_zip_videos(tmp_path / "videos")
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps({"batch_size": 1, "sample_length": 2, "log_freq": 1,
                                  "save_freq": 1000}))
    save = str(tmp_path / "ckpt")
    args = ["--data", data, "--config", str(config), "--save-dir", save, "--device", "cpu"]
    assert train_sttn.main(args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[1] dis_loss=" in out and "[2] dis_loss=" in out
    assert f"final checkpoint: {os.path.join(os.path.abspath(save), 'ckpt_2.pt')}" in out
    assert train_sttn.main(args + ["--steps", "3", "--resume",
                                   os.path.join(save, "ckpt_2.pt")]) == 0
    out = capsys.readouterr().out
    assert "[3] dis_loss=" in out and "[1] dis_loss=" not in out
    assert os.path.exists(os.path.join(save, "ckpt_3.pt"))


def test_train_sttn_without_card_raises(tmp_path, tiny_cli_models, monkeypatch):
    """--device defaults to cuda: no card, no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_sttn.main(["--data", make_zip_videos(tmp_path / "videos"), "--steps", "1"])


def test_train_sttn_distributed_exits_naming_the_roadmap_item(tmp_path, monkeypatch):
    """--distributed trains under torchrun (tests/test_torch_distributed.py);
    without torchrun's environment it raises naming the missing variables,
    and trains nothing alone."""
    from vsr_tpu_torch.parallel.distributed import TORCHRUN_ENV

    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun.*RANK, WORLD_SIZE, LOCAL_RANK"):
        train_sttn.main(["--data", str(tmp_path), "--distributed", "--device", "cpu"])


# ---- F6: the kernel is forward-only ----


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    q, k, v = (torch.randn(1, 8, 16) for _ in range(3))
    ta._forward_only(q, k, v)
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only.*use_kernel=False"):
        ta._forward_only(q, k, v)
    with torch.no_grad():
        ta._forward_only(q, k, v)
    with torch.inference_mode():
        ta._forward_only(q, k, v)
