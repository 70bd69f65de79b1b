"""Process groups for training: one process per device, torchrun's way.

The port's counterpart of the JAX package's training mesh, a ("data",
"model") grid of devices driven by one process (vsr_tpu/parallel/mesh.py,
the ``mesh=`` of vsr_tpu/train/sttn_trainer.py and propainter_trainer.py).
Here each device has a process of its own: ``init_distributed`` joins the
world that torchrun describes in the environment, and ``TrainingMesh`` lays
its ranks out as ``data x model`` process groups, rank = d * model + m, as
JAX's ``np.array(devices).reshape(data, model)`` lays out devices.

GSPMD computes every loss and metric over the global batch. The trainers get
the same numbers from the collectives below: each data rank takes its slice
of the global batch (``local_batch``), a loss's data-dependent denominator
is averaged over the data group (``data_mean``, no gradient), gradients are
averaged over it before each optimizer step (``average_gradients``, one
bucket per dtype), and so are the reported metrics.

Every collective is an ``all_reduce`` or a ``broadcast``: gloo supports only
those two on CUDA tensors, so the same code runs over gloo on the CPU, over
gloo with several ranks on one card, and over NCCL with one rank per card.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from vsr_tpu_torch.utils.device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device. The backend follows the device: a bare
    "cuda" is ``cuda:LOCAL_RANK``, one rank per card, over NCCL (a local
    rank without a card of its own raises); an explicit "cuda:N", which
    ranks may share (NCCL refuses two ranks on one card), and "cpu" take
    gloo. Without torchrun's variables it raises: it never runs a world of
    one in their place. A second call in an initialised process checks
    that it is the same world over the same backend and returns the
    device."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"distributed training needs torchrun's environment (torchrun "
                           f"--nproc_per_node=N ...); missing {', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device)
    one_per_card = dev.type == "cuda" and dev.index is None
    if one_per_card:
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    if one_per_card and local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card of its own "
                           f"({torch.cuda.device_count()} visible)")
    backend = "nccl" if one_per_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size(), dist.get_backend()) != (rank, world, backend):
            raise RuntimeError(f"a process group of rank {dist.get_rank()} of "
                               f"{dist.get_world_size()} over {dist.get_backend()} exists; "
                               f"the environment asks for rank {rank} of {world} over {backend}")
        return dev
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev


class TrainingMesh:
    """``data x model`` process groups over the initialised world (every rank
    builds the mesh, with the same arguments, in the same order).

    ``data`` defaults to world // model. ``data_group`` / ``model_group``
    are this rank's groups: None where the axis has one rank, the world
    group where it has them all."""

    def __init__(self, data: Optional[int] = None, model: int = 1):
        if not dist.is_initialized():
            raise RuntimeError("a training mesh needs an initialised process group "
                               "(init_distributed)")
        world, self.rank = dist.get_world_size(), dist.get_rank()
        if data is None:
            data = world // model
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} ranks")
        self.data, self.model = data, model
        self.data_index, self.model_index = divmod(self.rank, model)
        self.data_group = self._group([[d * model + m for d in range(data)] for m in range(model)])
        self.model_group = self._group([[d * model + m for m in range(model)] for d in range(data)])

    def _group(self, layout: List[List[int]]):
        """This rank's group of ``layout`` (the ranks of each group); every
        rank creates every group, in one order, as ``new_group`` requires."""
        if len(layout[0]) == 1:
            return None
        if len(layout) == 1:
            return dist.group.WORLD
        mine = None
        for ranks in layout:
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints and scalars."""
        return self.rank == 0

    def local_batch(self, x):
        """This data rank's slice of a global batch (dim 0)."""
        if x.shape[0] % self.data:
            raise ValueError(f"global batch {x.shape[0]} does not divide over {self.data} "
                             "data ranks")
        b = x.shape[0] // self.data
        return x[self.data_index * b:(self.data_index + 1) * b]

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data group, without a gradient: a
        per-rank mean over equal slices becomes the global batch's."""
        if self.data_group is None:
            return t.detach()
        out = t.detach().clone()
        dist.all_reduce(out, group=self.data_group)
        return out / self.data

    def average_gradients(self, module: nn.Module) -> None:
        """Average the parameters' gradients over the data group, one
        all_reduce per dtype."""
        if self.data_group is not None:
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            _bucketed(grads, lambda flat: dist.all_reduce(flat, group=self.data_group),
                      scale=1.0 / self.data)

    def broadcast_(self, module: nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        tensors = [t.data for t in (*module.parameters(), *module.buffers())]
        _bucketed(tensors, lambda flat: dist.broadcast(flat, 0))

    def barrier(self, device: torch.device) -> None:
        """Every rank waits for the others (an all_reduce, which both
        backends support on both devices)."""
        dist.all_reduce(torch.zeros(1, device=device))


def _bucketed(tensors: Sequence[torch.Tensor], collective, scale: Optional[float] = None) -> None:
    """Run ``collective`` in place on one flat buffer per dtype holding
    ``tensors``, and copy the result (times ``scale``) back."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        if scale is not None:
            flat.mul_(scale)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
