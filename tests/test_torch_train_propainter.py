"""The port's ProPainter training (train/propainter_trainer.py, the flow
net's edge head) against the JAX package's on the CPU, from the same flax
variables, at the tiny shapes of tests/test_propainter_trainer.py:

* the edge head, and the flow net's train forward (flow and edges), within
  1e-5;
* one flow-completion step against ``make_flow_train_step``: metrics within
  1e-4 relative, parameters within 2e-6;
* one ProPainter GAN step against ``make_propainter_train_step`` (generator
  channel 16, hidden 32, one block; discriminator nf 8; 3 frames of 64x48,
  2 local), without the LPIPS term here and with it in
  tests/test_torch_train_lpips.py: metrics within 1e-4 relative, parameters
  within 1e-5, but for the attention's key bias (see check_gan_step);
* checkpoints, the edge head's load rules and the trainers' defaults.

Each JAX step compiles once per module (fixtures).
"""

import types

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_train import draw_discriminator, draw_params, port_discriminator, to_np
from vsr_tpu.models.discriminator import VideoDiscriminator as FlaxDiscriminator
from vsr_tpu.models.lpips import LPIPS as FlaxLPIPS
from vsr_tpu.models.propainter.flow_completion import EdgeDetector as FlaxEdgeDetector
from vsr_tpu.models.propainter.flow_completion import RecurrentFlowCompleteNet as FlaxFlowNet
from vsr_tpu.models.propainter.generator import ProPainterGenerator as FlaxGenerator
from vsr_tpu.train import propainter_trainer as jax_pt
from vsr_tpu_torch.convert import params_io
from vsr_tpu_torch.convert.from_flax import (
    discriminator_state_dict_from_flax,
    flow_completion_state_dict_from_flax,
    lpips_state_dict_from_flax,
    propainter_state_dict_from_flax,
)
from vsr_tpu_torch.inpaint.weights import load_flow_completion_weights
from vsr_tpu_torch.models.lpips import LPIPS
from vsr_tpu_torch.models.propainter.flow_completion import EdgeDetector, RecurrentFlowCompleteNet
from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
from vsr_tpu_torch.train.propainter_trainer import (
    FlowCompletionTrainer,
    FlowTrainConfig,
    PropainterTrainConfig,
    PropainterTrainer,
)
from vsr_tpu_torch.train.sttn_trainer import as_floats

METRIC_RTOL = 1e-4
FLOW_PARAM_ATOL = 2e-6
GAN_PARAM_ATOL = 1e-5
TINY_GEN = dict(channel=16, hidden=32, depths=1, n_head=2, window_size=(3, 4), pool_size=(2, 2))
B, T, H, W, L_T = 1, 3, 48, 64, 2


def _t(a):
    """[..., H, W, C] numpy -> the port's [..., C, H, W] tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def _np(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def smooth_flows(rng, n, h, w, scale=4.0):
    """n [h, w, 2] flow fields with structure: 1/8-scale noise, upsampled."""
    base = torch.from_numpy(rng.normal(0, scale, (n * 2, 1, h // 8, w // 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
    return np.moveaxis(up.reshape(n, 2, h, w).numpy(), 1, -1)


# ---- the edge head and the flow net's train forward ----


def test_edge_head_matches_jax():
    flax_head = FlaxEdgeDetector()
    flow = np.random.default_rng(0).normal(0, 2, (3, 24, 32, 2)).astype(np.float32)
    params = draw_params(jax.eval_shape(flax_head.init, jax.random.PRNGKey(0), flow), 1)
    want = flax_head.apply(params, jnp.asarray(flow))
    state = flow_completion_state_dict_from_flax({"params": {"edge": params["params"]}})
    head = EdgeDetector()
    head.load_state_dict({k[len("edge."):]: v for k, v in state.items()}, strict=True)
    np.testing.assert_allclose(_np(head(_t(flow))), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def flow_net():
    flax_net = FlaxFlowNet()
    shapes = jax.eval_shape(lambda r: flax_net.init(r, jnp.zeros((B, 2, 32, 32, 2)),
                                                    jnp.zeros((B, 2, 32, 32, 1)), train=True),
                            jax.random.PRNGKey(0))
    return flax_net, draw_params(shapes, 3)


def flow_batch(seed):
    rng = np.random.default_rng(seed)
    flows = smooth_flows(rng, 2, 32, 32)[None]
    masks = np.zeros((B, 2, 32, 32, 1), np.float32)
    masks[:, :, 8:24, 8:24] = 1.0
    return flows, masks


def test_flow_net_train_forward_matches_jax(flow_net):
    flax_net, variables = flow_net
    flows, masks = flow_batch(1)
    masked = flows * (1 - masks)
    want_flow, want_edges = jax.jit(lambda v, f, m: flax_net.apply(v, f, m, train=True))(
        variables, jnp.asarray(masked), jnp.asarray(masks))
    net = RecurrentFlowCompleteNet(edge_head=True)
    net.load_state_dict(flow_completion_state_dict_from_flax(variables), strict=True)
    got_flow, got_edges = net(_t(masked), _t(masks), train=True)
    np.testing.assert_allclose(_np(got_flow), np.asarray(want_flow), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_edges), np.asarray(want_edges), rtol=1e-5, atol=1e-5)
    # inference's forward is the same flow without the head
    np.testing.assert_array_equal(net(_t(masked), _t(masks)).detach().numpy(),
                                  got_flow.detach().numpy())


def test_flow_step_matches_jax(flow_net):
    flax_net, variables = flow_net
    flows, masks = flow_batch(2)
    cfg = jax_pt.FlowTrainConfig()
    opt = optax.adam(cfg.lr, b1=cfg.beta1, b2=cfg.beta2)
    state = jax_pt.FlowTrainState(step=jnp.zeros((), jnp.int32), params=variables,
                                  opt=opt.init(variables))
    edges = jax_pt.flow_edges_host(flows)
    assert edges.sum() > 0  # the edge term sees edges
    state, want = jax_pt.make_flow_train_step(flax_net, cfg)(
        state, *map(jnp.asarray, (flows, masks, edges)))
    net = RecurrentFlowCompleteNet(edge_head=True)
    net.load_state_dict(flow_completion_state_dict_from_flax(variables), strict=True)
    trainer = FlowCompletionTrainer(FlowTrainConfig(), net=net, device="cpu")
    got = as_floats(trainer.train_step(_t(flows), _t(masks)))
    assert set(got) == {"loss", "hole_l1", "valid_l1", "edge_bce"}
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=METRIC_RTOL), k
    want_state = flow_completion_state_dict_from_flax(to_np(state.params))
    for k, v in trainer.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), atol=FLOW_PARAM_ATOL,
                                   err_msg=k)


def test_flow_trainer_checkpoint_and_defaults(flow_net, tmp_path):
    _, variables = flow_net
    flows, masks = flow_batch(3)
    net = RecurrentFlowCompleteNet(edge_head=True)
    net.load_state_dict(flow_completion_state_dict_from_flax(variables), strict=True)
    trainer = FlowCompletionTrainer(FlowTrainConfig(save_dir=str(tmp_path)), net=net,
                                    device="cpu")
    trainer.train_step(_t(flows), _t(masks))
    path = trainer.save()
    cont = as_floats(trainer.train_step(_t(flows), _t(masks)))
    other = FlowCompletionTrainer(device="cpu", seed=4)
    other.restore(path)
    assert other.step_count == 1 and path.endswith("ckpt_1.pt")
    assert as_floats(other.train_step(_t(flows), _t(masks))) == cont
    with pytest.raises(ValueError, match="edge head"):
        FlowCompletionTrainer(net=RecurrentFlowCompleteNet(), device="cpu")
    with pytest.raises(ValueError, match="edge head"):
        RecurrentFlowCompleteNet()(_t(flows), _t(masks), train=True)
    with pytest.raises(TypeError, match="TrainingMesh"):  # an inference mesh
        FlowCompletionTrainer(device="cpu", mesh=["cpu"])


def test_edge_head_load_rules(flow_net, tmp_path):
    """A checkpoint's edge head loads into a net built with it; a net
    without one leaves it out; a checkpoint without it still loads strictly
    into an inference net."""
    _, variables = flow_net
    with_edge = str(tmp_path / "with_edge.npz")
    params_io.save_params(with_edge, variables)
    without = str(tmp_path / "without.npz")
    params_io.save_params(without, {"params": {k: v for k, v in variables["params"].items()
                                               if k != "edge"}})
    trainer_net = RecurrentFlowCompleteNet(edge_head=True)
    load_flow_completion_weights(trainer_net, with_edge)
    want = flow_completion_state_dict_from_flax(variables)
    for k, v in trainer_net.state_dict().items():
        assert torch.equal(v, want[k]), k
    for path in (with_edge, without):
        inference_net = RecurrentFlowCompleteNet()
        load_flow_completion_weights(inference_net, path)
        assert inference_net.edge is None
        assert torch.equal(inference_net.down.weight, want["down.weight"])
    with pytest.raises(RuntimeError, match="edge"):
        load_flow_completion_weights(RecurrentFlowCompleteNet(edge_head=True), without)


# ---- the ProPainter GAN step ----


@pytest.fixture(scope="module")
def gan_setup():
    """Drawn generator, discriminator and LPIPS variables, one batch."""
    fg, fd = FlaxGenerator(**TINY_GEN), FlaxDiscriminator(nf=8)
    zeros = jnp.zeros((B, T, H, W, 3))
    flows0 = jnp.zeros((B, L_T - 1, H, W, 2))
    mask0 = jnp.zeros((B, T, H, W, 1))
    gen_shapes = jax.eval_shape(lambda r: fg.init(r, zeros, (flows0, flows0), mask0, mask0, L_T),
                                jax.random.PRNGKey(0))
    dis_params, stats = draw_discriminator(fd, 2, zeros[:, :L_T])
    lpips_shapes = jax.eval_shape(FlaxLPIPS().init, jax.random.PRNGKey(0),
                                  zeros[:, 0], zeros[:, 0])
    rng = np.random.default_rng(3)
    frames = rng.uniform(-1, 1, (B, T, H, W, 3)).astype(np.float32)
    masks = np.zeros((B, T, H, W, 1), np.float32)
    masks[:, :, 16:32, 16:48] = 1.0
    flows_f, flows_b = (smooth_flows(rng, L_T - 1, H, W, 2.0)[None] for _ in range(2))
    return types.SimpleNamespace(
        fg=fg, fd=fd, gen=draw_params(gen_shapes, 1), dis=dis_params, stats=stats,
        lpips=draw_params(lpips_shapes, 4), batch=(frames, flows_f, flows_b, masks), runs={})


def jax_gan_step(setup, perceptual_weight):
    """make_propainter_train_step once per weight: (metrics, final state)."""
    if perceptual_weight not in setup.runs:
        cfg = jax_pt.PropainterTrainConfig(perceptual_weight=perceptual_weight)
        opt = optax.adam(cfg.lr, b1=cfg.beta1, b2=cfg.beta2)
        state = jax_pt.PropainterTrainState(
            step=jnp.zeros((), jnp.int32), gen_params=setup.gen, gen_opt=opt.init(setup.gen),
            dis_params=setup.dis, dis_vars={"batch_stats": setup.stats},
            dis_opt=opt.init(setup.dis))
        step = jax_pt.make_propainter_train_step(setup.fg, setup.fd, cfg, L_T,
                                                 lpips_params=setup.lpips)
        state, metrics = step(state, *map(jnp.asarray, setup.batch))
        setup.runs[perceptual_weight] = ({k: float(v) for k, v in metrics.items()},
                                         to_np(state))
    return setup.runs[perceptual_weight]


def port_gan_trainer(setup, perceptual_weight, **cfg):
    gen = ProPainterGenerator(**TINY_GEN)
    gen.load_state_dict(propainter_state_dict_from_flax(setup.gen), strict=True)
    lpips = LPIPS()
    lpips.load_state_dict(lpips_state_dict_from_flax(setup.lpips), strict=True)
    return PropainterTrainer(PropainterTrainConfig(perceptual_weight=perceptual_weight, **cfg),
                             L_T, gen, port_discriminator(setup.dis, setup.stats), lpips,
                             device="cpu")


def port_batch(setup):
    return tuple(_t(x) for x in setup.batch)


def check_gan_step(gan_setup, perceptual_weight):
    """Every metric within 1e-4 relative; parameters within 1e-5, but for
    the attention's key bias: a bias shared by every key leaves softmax
    unchanged, so its exact gradient is zero and both packages get rounding
    noise near Adam's eps (1e-8), which its first step (beta1 = 0) turns
    into moves of up to lr; it is held to lr."""
    want, final = jax_gan_step(gan_setup, perceptual_weight)
    trainer = port_gan_trainer(gan_setup, perceptual_weight)
    got = as_floats(trainer.step(*port_batch(gan_setup)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=METRIC_RTOL, abs=1e-12), k
    assert (got["perc_loss"] > 0) == (perceptual_weight > 0)
    gen_want = propainter_state_dict_from_flax(final.gen_params)
    for k, v in trainer.generator.state_dict().items():
        atol = PropainterTrainConfig.lr if k.endswith("attention.key.bias") else GAN_PARAM_ATOL
        np.testing.assert_allclose(v.numpy(), gen_want[k].numpy(), atol=atol, err_msg=k)
    dis_want = discriminator_state_dict_from_flax(final.dis_params,
                                                  final.dis_vars["batch_stats"])
    for k, v in trainer.discriminator.state_dict().items():
        np.testing.assert_allclose(v.numpy(), dis_want[k].numpy(), atol=GAN_PARAM_ATOL,
                                   err_msg=k)


def test_gan_step_matches_jax(gan_setup):
    """Without the LPIPS term (the published default); with it:
    tests/test_torch_train_lpips.py, so that each file's JAX compiles stay
    near half a minute."""
    check_gan_step(gan_setup, 0.0)


def test_gan_trainer_checkpoint_and_defaults(gan_setup, tmp_path):
    trainer = port_gan_trainer(gan_setup, 0.1, save_dir=str(tmp_path))
    batch = port_batch(gan_setup)
    trainer.step(*batch)
    path = trainer.save()
    cont = as_floats(trainer.step(*batch))
    other = PropainterTrainer(PropainterTrainConfig(perceptual_weight=0.1), L_T,
                              ProPainterGenerator(**TINY_GEN),
                              port_discriminator(gan_setup.dis, gan_setup.stats),
                              trainer.lpips, device="cpu", seed=9)
    other.restore(path)
    assert other.step_count == 1
    assert as_floats(other.step(*batch)) == cont
    # the LPIPS network is frozen: the step leaves it as it was
    assert not any(p.requires_grad for p in trainer.lpips.parameters())
    # defaults: the published discriminator width, no LPIPS term without a module
    default = PropainterTrainer(num_local_frames=L_T, generator=ProPainterGenerator(**TINY_GEN),
                                device="cpu")
    assert default.discriminator.conv0.weight.shape[0] == 32
    assert default.lpips is None
    with pytest.raises(TypeError, match="TrainingMesh"):  # an inference mesh
        PropainterTrainer(generator=ProPainterGenerator(**TINY_GEN), device="cpu", mesh=["cpu"])
