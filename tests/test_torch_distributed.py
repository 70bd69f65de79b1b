"""Training across processes (vsr_tpu_torch/parallel/distributed.py, the
tensor-parallel half of parallel/mesh.py, the trainers' ``mesh=`` and
``train_sttn --distributed``) on the CPU: ranks are spawned processes
(``torch.multiprocessing``, module-level functions below) in a gloo world,
each given torchrun's environment and joining it through
``init_distributed("cpu")``.

* Two data ranks, one sample each, against one process on the global batch
  of two, from the same weights (rank 1 starts from other weights: the
  trainer broadcasts rank 0's): two STTN steps with a different hole in
  every sample, and the per-rank normalisation that the global mask
  density replaces shown to miss the tolerance on this data; the same two
  ranks against ``vsr_tpu``'s ``make_train_step(mesh=...)`` over two
  devices of the ``cpu_mesh`` fixture, from the same flax variables; one
  flow-completion step and one ProPainter GAN step; ``train_sttn.main
  --distributed``: rank 0 alone writes the checkpoints, both ranks restore.
* Four ranks as data 2 x model 2 against one process: convolutions split
  over the model group, a checkpoint gathered to full tensors, and a
  trainer restored from it stepping as the one that saved it.
* ``--distributed`` without torchrun's environment raises
  (tests/test_torch_train.py, ``test_train_sttn_distributed_exits_...``).

Bounds: losses within 1e-5 relative, parameters within 2e-6 (ProPainter's
within 1e-5, its attention key bias within lr as in
tests/test_torch_train_propainter.py). This module imports torch only at its
top: the spawned ranks import it.
"""

import functools
import os
import socket
import time

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
PP_PARAM_ATOL = 1e-5
TINY_PATCHES = ((4, 3), (2, 2))
TINY_CFG = dict(frame_w=32, frame_h=24, sample_length=2, batch_size=2, save_freq=10 ** 9)
PP_GEN = dict(channel=16, hidden=32, depths=1, n_head=2, window_size=(3, 4), pool_size=(2, 2))
PP_SHAPE = (2, 3, 48, 64)  # B, T, H, W; the first 2 frames local
PP_LOCAL = 2
RANKS_TIMEOUT_S = 240


# ---- spawning ranks ----


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # Under xdist the rank already starts at one thread: it inherits
    # OMP_NUM_THREADS from tests/torch_test_env.py. Alone, pytest leaves
    # torch at the host's width, and the ranks still share the cores.
    torch.set_num_threads(1)
    from vsr_tpu_torch.parallel.distributed import init_distributed

    init_distributed("cpu")
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(world, fn, *args):
    """fn(rank, *args) in ``world`` spawned processes over gloo; raises with
    a rank's traceback if one fails, and fails the test after
    RANKS_TIMEOUT_S."""
    ctx = mp.start_processes(_rank_main, args=(world, _free_port(), fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks of {fn.__name__} did not finish in {RANKS_TIMEOUT_S} s")


# ---- the models and data, shared by the ranks and the one-process runs ----


def sttn_models(setup):
    from vsr_tpu_torch.models.discriminator import VideoDiscriminator
    from vsr_tpu_torch.models.sttn import STTNGenerator

    gen = STTNGenerator(variant="det", channel=16, stack_num=1,
                        patchsizes_override=TINY_PATCHES, use_kernel=False)
    gen.load_state_dict(setup["gen"], strict=True)
    dis = VideoDiscriminator(nf=8)
    dis.load_state_dict(setup["dis"], strict=True)
    return gen, dis


def sttn_trainer(setup, mesh=None, **cfg):
    from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig

    gen, dis = sttn_models(setup)
    return STTNTrainer(TrainConfig(**{**TINY_CFG, **cfg}), generator=gen, discriminator=dis,
                       device="cpu", mesh=mesh)


def sttn_batch(seed, batch=2, length=2, h=24, w=32):
    """Uniform frames and a different hole in every sample and frame."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (batch, length, h, w, 3)).astype(np.float32)
    masks = np.zeros((batch, length, h, w, 1), np.float32)
    for b in range(batch):
        for t in range(length):
            y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
            masks[b, t, y:y + rng.integers(2, h // 2), x:x + rng.integers(2, w // 2)] = 1.0
    return frames, masks


def flow_batch(seed, batch=2, length=2, size=32):
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.normal(0, 4, (batch * length * 2, 1, size // 8, size // 8))
                            .astype(np.float32))
    flows = torch.nn.functional.interpolate(base, size=(size, size), mode="bilinear",
                                            align_corners=False)
    flows = flows.reshape(batch, length, 2, size, size).numpy()
    masks = np.zeros((batch, length, 1, size, size), np.float32)
    masks[0, :, :, 8:24, 8:24] = 1.0
    masks[1, :, :, 2:10, 4:30] = 1.0
    return flows, masks


def pp_batch(seed):
    B, T, H, W = PP_SHAPE
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (B, T, 3, H, W)).astype(np.float32)
    masks = np.zeros((B, T, 1, H, W), np.float32)
    masks[0, :, :, 16:32, 16:48] = 1.0
    masks[1, :, :, 4:20, 8:60] = 1.0
    flows = rng.normal(0, 2, (2, B, PP_LOCAL - 1, 2, H, W)).astype(np.float32)
    return frames, flows[0], flows[1], masks


def flow_trainer(setup, mesh=None):
    from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet
    from vsr_tpu_torch.train.propainter_trainer import FlowCompletionTrainer

    net = RecurrentFlowCompleteNet(edge_head=True)
    net.load_state_dict(setup["flow"], strict=True)
    return FlowCompletionTrainer(net=net, device="cpu", mesh=mesh)


def pp_trainer(setup, mesh=None):
    from vsr_tpu_torch.models.discriminator import VideoDiscriminator
    from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
    from vsr_tpu_torch.train.propainter_trainer import PropainterTrainer

    gen = ProPainterGenerator(**PP_GEN)
    gen.load_state_dict(setup["pp_gen"], strict=True)
    dis = VideoDiscriminator(nf=8)
    dis.load_state_dict(setup["pp_dis"], strict=True)
    return PropainterTrainer(num_local_frames=PP_LOCAL, generator=gen, discriminator=dis,
                             device="cpu", mesh=mesh)


def run_jobs(setup, mesh=None):
    """The three trainers' steps: (metrics per job and step, final state
    dicts); the same code for a rank and for one process."""
    from vsr_tpu_torch.train.sttn_trainer import as_floats

    metrics, states = {}, {}
    trainer = sttn_trainer(setup, mesh)
    metrics["sttn"] = [as_floats(trainer.step(*sttn_batch(s))) for s in (0, 1)]
    states["sttn_gen"], states["sttn_dis"] = (trainer.generator.state_dict(),
                                              trainer.discriminator.state_dict())
    trainer = flow_trainer(setup, mesh)
    metrics["flow"] = [as_floats(trainer.train_step(*flow_batch(2)))]
    states["flow"] = trainer.net.state_dict()
    trainer = pp_trainer(setup, mesh)
    metrics["pp"] = [as_floats(trainer.step(*pp_batch(3)))]
    states["pp_gen"], states["pp_dis"] = (trainer.generator.state_dict(),
                                          trainer.discriminator.state_dict())
    return metrics, states


# ---- what the ranks run ----


def _data_parallel_rank(rank, setup_path, out_dir, cli_args):
    from vsr_tpu_torch.models.discriminator import VideoDiscriminator
    from vsr_tpu_torch.models.sttn import STTNGenerator
    from vsr_tpu_torch.parallel.distributed import TrainingMesh
    from vsr_tpu_torch.train import sttn_trainer, train_sttn

    setup = torch.load(setup_path, weights_only=True)
    if rank != 0:  # other weights than rank 0's: the trainers broadcast rank 0's
        setup = {k: {n: v + 0.5 if v.is_floating_point() else v for n, v in sd.items()}
                 for k, sd in setup.items()}
    metrics, states = run_jobs(setup, TrainingMesh())
    torch.save({"metrics": metrics, "states": states}, os.path.join(out_dir, f"rank{rank}.pt"))

    # train_sttn --distributed, at test width (the CLI's networks shrunk)
    sttn_trainer.STTNGenerator = functools.partial(STTNGenerator, channel=16, stack_num=1)
    sttn_trainer.VideoDiscriminator = functools.partial(VideoDiscriminator, nf=4)
    saves, restored = [], []
    real_save, real_restore = torch.save, sttn_trainer.STTNTrainer.restore

    def counting_save(obj, path, *a, **kw):
        saves.append(os.path.basename(path))
        return real_save(obj, path, *a, **kw)

    def recording_restore(self, path):
        real_restore(self, path)
        restored.append(self.step_count)

    torch.save, sttn_trainer.STTNTrainer.restore = counting_save, recording_restore
    try:
        assert train_sttn.main(cli_args + ["--steps", "2"]) == 0
        ckpt = os.path.join(cli_args[cli_args.index("--save-dir") + 1], "ckpt_2.pt")
        assert train_sttn.main(cli_args + ["--steps", "3", "--resume", ckpt]) == 0
    finally:
        torch.save, sttn_trainer.STTNTrainer.restore = real_save, real_restore
    real_save({"saves": saves, "restored": restored}, os.path.join(out_dir, f"cli{rank}.pt"))


def _tensor_parallel_rank(rank, setup_path, out_dir):
    from vsr_tpu_torch.parallel.distributed import TrainingMesh
    from vsr_tpu_torch.train.sttn_trainer import as_floats

    setup = torch.load(setup_path, weights_only=True)
    mesh = TrainingMesh(data=2, model=2)
    trainer = sttn_trainer(setup, mesh, save_dir=out_dir)
    shapes = {n: tuple(p.shape) for n, p in trainer.generator.named_parameters()}
    metrics = [as_floats(trainer.step(*sttn_batch(0)))]
    path = trainer.save()  # every rank: the shards are gathered
    metrics.append(as_floats(trainer.step(*sttn_batch(1))))
    state = trainer.generator.state_dict()  # full tensors, gathered
    resumed = sttn_trainer({k: {n: v + 0.5 if v.is_floating_point() else v for n, v in sd.items()}
                            for k, sd in setup.items()}, mesh)
    resumed.restore(path)
    again = as_floats(resumed.step(*sttn_batch(1)))
    if rank == 0:
        torch.save({"metrics": metrics, "again": again, "gen": state, "sharded": trainer.sharded,
                    "shapes": shapes, "ckpt": path}, os.path.join(out_dir, "tp.pt"))


# ---- fixtures: the drawn weights, the ranks' runs, the one-process runs ----


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights drawn with numpy in flax's trees (as tests/test_torch_train.py
    draws them), moved to the port's state dicts; saved for the ranks."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_train import draw_discriminator, draw_params
    from vsr_tpu.models.discriminator import VideoDiscriminator as FlaxDiscriminator
    from vsr_tpu.models.propainter.flow_completion import RecurrentFlowCompleteNet as FlaxFlow
    from vsr_tpu.models.propainter.generator import ProPainterGenerator as FlaxPP
    from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
    from vsr_tpu_torch.convert.from_flax import (
        discriminator_state_dict_from_flax,
        flow_completion_state_dict_from_flax,
        propainter_state_dict_from_flax,
        sttn_state_dict_from_flax,
    )

    frames, masks = sttn_batch(0)
    fg = FlaxSTTN(variant="det", channel=16, stack_num=1, patchsizes_override=TINY_PATCHES)
    gen_params = draw_params(jax.eval_shape(fg.init, jax.random.PRNGKey(0), frames, masks), 1)
    dis_params, stats = draw_discriminator(FlaxDiscriminator(nf=8), 2, frames)
    flow_shapes = jax.eval_shape(lambda r: FlaxFlow().init(
        r, jnp.zeros((1, 2, 32, 32, 2)), jnp.zeros((1, 2, 32, 32, 1)), train=True),
        jax.random.PRNGKey(0))
    B, T, H, W = PP_SHAPE
    zeros, flows0, mask0 = (jnp.zeros((1, T, H, W, 3)), jnp.zeros((1, PP_LOCAL - 1, H, W, 2)),
                            jnp.zeros((1, T, H, W, 1)))
    pp_shapes = jax.eval_shape(lambda r: FlaxPP(**PP_GEN).init(
        r, zeros, (flows0, flows0), mask0, mask0, PP_LOCAL), jax.random.PRNGKey(0))
    pp_dis, pp_stats = draw_discriminator(FlaxDiscriminator(nf=8), 5, np.zeros((1, PP_LOCAL, H, W, 3),
                                                                                np.float32))
    data = {
        "gen": sttn_state_dict_from_flax(gen_params),
        "dis": discriminator_state_dict_from_flax(dis_params, stats),
        "flow": flow_completion_state_dict_from_flax(draw_params(flow_shapes, 3)),
        "pp_gen": propainter_state_dict_from_flax(draw_params(pp_shapes, 4)),
        "pp_dis": discriminator_state_dict_from_flax(pp_dis, pp_stats),
    }
    d = tmp_path_factory.mktemp("distributed")
    path = str(d / "setup.pt")
    torch.save(data, path)
    return {"path": str(path), "dir": d, "data": data, "flax": (fg, gen_params, dis_params, stats)}


@pytest.fixture(scope="module")
def data_ranks(setup):
    """Two data ranks: the three trainers' steps, then the CLI."""
    from tests.test_torch_train import make_zip_videos

    d = setup["dir"]
    out = d / "dp"
    out.mkdir()
    config = d / "cli.json"
    config.write_text('{"batch_size": 2, "sample_length": 2, "log_freq": 1, "save_freq": 1000}')
    cli_args = ["--data", make_zip_videos(d / "videos"), "--config", str(config),
                "--save-dir", str(d / "cli_ckpt"), "--device", "cpu", "--distributed"]
    run_ranks(2, _data_parallel_rank, setup["path"], str(out), cli_args)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    cli = [torch.load(out / f"cli{r}.pt", weights_only=True) for r in range(2)]
    return ranks, cli, d / "cli_ckpt"


@pytest.fixture(scope="module")
def one_process(setup):
    torch.manual_seed(0)
    metrics, states = run_jobs(setup["data"])
    return metrics, states


def assert_losses(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL, abs=1e-12), (what, k)


def assert_states(got, want, what, atol=PARAM_ATOL, key_bias_atol=None):
    assert set(got) == set(want), what
    for k in want:
        tol = key_bias_atol if key_bias_atol and k.endswith("attention.key.bias") else atol
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=tol,
                                   err_msg=f"{what} {k}")


# ---- the tests ----


def test_two_data_ranks_equal_one_process_sttn(data_ranks, one_process, setup):
    """Two STTN steps: every metric on both ranks within 1e-5 relative of
    the one-process step on the global batch, both networks within 2e-6."""
    ranks, _, _ = data_ranks
    metrics, states = one_process
    for r, rank in enumerate(ranks):
        for got, want in zip(rank["metrics"]["sttn"], metrics["sttn"]):
            assert_losses(got, want, f"sttn rank {r}")
        assert_states(rank["states"]["sttn_gen"], states["sttn_gen"], f"generator rank {r}")
        assert_states(rank["states"]["sttn_dis"], states["sttn_dis"], f"discriminator rank {r}",
                      atol=1e-5)


def test_per_rank_normalisation_would_miss(setup):
    """The data has teeth: on it, each rank normalising its hole L1 by its
    own mask density (the mean of the ranks' losses) misses the
    one-process loss by far more than the tolerance. (The valid term's
    densities, near 0.9 on both ranks, differ less.)"""
    from vsr_tpu_torch.train.losses import masked_l1

    gen, _ = sttn_models(setup["data"])
    frames, masks = map(torch.from_numpy, sttn_batch(0))
    with torch.no_grad():
        pred = gen(frames * (1 - masks), masks)
    whole = float(masked_l1(pred, frames, masks))
    per_rank = float(sum(masked_l1(pred[r:r + 1], frames[r:r + 1], masks[r:r + 1])
                         for r in range(2))) / 2
    assert abs(per_rank - whole) / whole > 100 * LOSS_RTOL


def test_two_data_ranks_equal_vsr_tpu_mesh_step(data_ranks, setup, cpu_mesh):
    """The same two ranks against vsr_tpu's make_train_step(mesh=...) over
    two devices of cpu_mesh (data 2, model 1), from the same flax
    variables."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from vsr_tpu.models.discriminator import VideoDiscriminator as FlaxDiscriminator
    from vsr_tpu.train import sttn_trainer as jax_trainer
    from vsr_tpu_torch.convert.from_flax import (
        discriminator_state_dict_from_flax,
        sttn_state_dict_from_flax,
    )

    fg, gen_params, dis_params, stats = setup["flax"]
    cfg = jax_trainer.TrainConfig(**TINY_CFG)
    opt = jax_trainer.make_optimizer(cfg)
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen_params, gen_opt=opt.init(gen_params),
        dis_params=dis_params, dis_vars={"batch_stats": stats}, dis_opt=opt.init(dis_params))
    mesh = Mesh(cpu_mesh.devices[:2, :1], ("data", "model"))
    step = jax_trainer.make_train_step(fg, FlaxDiscriminator(nf=8), cfg, mesh=mesh)
    want = []
    with mesh:
        for seed in (0, 1):
            state, m = step(state, *map(jnp.asarray, sttn_batch(seed)))
            want.append({k: float(v) for k, v in m.items()})
    final = jax.tree_util.tree_map(np.asarray, state)
    ranks, _, _ = data_ranks
    for r, rank in enumerate(ranks):
        for got, w in zip(rank["metrics"]["sttn"], want):
            assert_losses(got, w, f"rank {r} vs vsr_tpu")
        assert_states(rank["states"]["sttn_gen"], sttn_state_dict_from_flax(final.gen_params),
                      f"generator rank {r} vs vsr_tpu")
    dis_want = discriminator_state_dict_from_flax(final.dis_params,
                                                  final.dis_vars["batch_stats"])
    assert_states(ranks[0]["states"]["sttn_dis"], dis_want, "discriminator vs vsr_tpu", atol=1e-5)


def test_two_data_ranks_equal_one_process_flow_completion(data_ranks, one_process):
    ranks, _, _ = data_ranks
    metrics, states = one_process
    for r, rank in enumerate(ranks):
        assert_losses(rank["metrics"]["flow"][0], metrics["flow"][0], f"flow rank {r}")
        assert_states(rank["states"]["flow"], states["flow"], f"flow net rank {r}")


def test_two_data_ranks_equal_one_process_propainter(data_ranks, one_process):
    from vsr_tpu_torch.train.propainter_trainer import PropainterTrainConfig

    ranks, _, _ = data_ranks
    metrics, states = one_process
    for r, rank in enumerate(ranks):
        assert_losses(rank["metrics"]["pp"][0], metrics["pp"][0], f"propainter rank {r}")
        assert_states(rank["states"]["pp_gen"], states["pp_gen"], f"generator rank {r}",
                      atol=PP_PARAM_ATOL, key_bias_atol=PropainterTrainConfig.lr)
        assert_states(rank["states"]["pp_dis"], states["pp_dis"], f"discriminator rank {r}",
                      atol=PP_PARAM_ATOL)


def test_train_sttn_distributed_rank0_writes_both_restore(data_ranks):
    """train_sttn.main(--distributed) in a world of two: the checkpoints
    (the final one of each run) come from rank 0 alone, and both ranks
    restore the first run's to step 2."""
    _, cli, ckpt_dir = data_ranks
    assert cli[0]["saves"] == ["ckpt_2.pt", "ckpt_3.pt"]
    assert cli[1]["saves"] == []
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_2.pt", "ckpt_3.pt"]
    assert cli[0]["restored"] == cli[1]["restored"] == [2]
    assert torch.load(ckpt_dir / "ckpt_3.pt", weights_only=True)["step"] == 3


def test_data_and_model_ranks_equal_one_process(setup, one_process):
    """Four ranks, data 2 x model 2: the generator's convolutions split over
    the model group (each rank holding half of a conv's output channels),
    two steps equal to one process, the checkpoint holding full tensors,
    and a trainer restored from it stepping as the one that saved it."""
    out = setup["dir"] / "tp"
    out.mkdir()
    run_ranks(4, _tensor_parallel_rank, setup["path"], str(out))
    tp = torch.load(out / "tp.pt", weights_only=True)
    metrics, states = one_process
    assert "encoder.0" in tp["sharded"] and "decoder.6" not in tp["sharded"]  # 3 outputs
    full = {k: tuple(v.shape) for k, v in setup["data"]["gen"].items()}
    assert tp["shapes"]["encoder.0.weight"][0] == full["encoder.0.weight"][0] // 2
    assert tp["shapes"]["decoder.6.weight"] == full["decoder.6.weight"]
    for got, want in zip(tp["metrics"], metrics["sttn"]):
        assert_losses(got, want, "data 2 x model 2")
    assert_states(tp["gen"], states["sttn_gen"], "generator, data 2 x model 2")
    saved = torch.load(tp["ckpt"], weights_only=True)["generator"]
    assert {k: tuple(v.shape) for k, v in saved.items()} == full
    assert_losses(tp["again"], tp["metrics"][1], "restored trainer")


def test_init_distributed_on_cuda_without_a_card_raises(monkeypatch):
    """A bare "cuda" (one rank per card, NCCL) on a machine without a card
    raises before joining any group; so does a mesh without a group."""
    from vsr_tpu_torch.parallel.distributed import TrainingMesh, init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        TrainingMesh()
