"""The device mesh of a multi-device run, over torch.distributed.

Counterpart of ``kgwas_tpu/parallel/mesh.py`` (``device_count``,
``init_distributed``, ``make_mesh``). The JAX package drives every device
of a host from one process; the port runs one process per device, as
PyTorch does (``torchrun``, or processes started by the caller), so a mesh
is the ranks of the initialised default process group: NCCL for CUDA
tensors, gloo for CPU tensors. Rank r sits at (r // model, r % model) of a
(data, model) grid, the JAX package's ``devices.reshape(data, model)``.
The 'data' axis partitions the layers' rows and edges (``merged_shard.py``,
``relation_shard.py``) in contiguous blocks (``split_bounds``) that need
not be equal, the 'model' axis the columns of wide feature tables
(``shard.py``).

The collectives with their gradients: ``all_gather_rows`` (backward: the
reduce-scatter of the cotangent) and ``all_reduce_sum`` (backward: the
all-reduce of the cotangent), each over one axis's group; blocks of
unequal sizes go padded to the largest. A mesh of one rank without a
process group (``make_mesh(1)`` in a plain process) has no groups, and its
collectives are the identity.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist


def device_count() -> int:
    """The devices a mesh can hold: one per rank of the default process
    group (1 in a process without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None):
    """Initialise the default process group and return (rank, world size).

    backend: 'nccl' (CUDA tensors) or 'gloo' (CPU tensors); by default NCCL
    when a card is present. init_method: 'tcp://localhost:<port>',
    'file://<path>', or None for 'env://' (torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT). With NCCL the process takes the card of
    its local rank (LOCAL_RANK, else rank % cards). A group that exists
    already is kept."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if (init_method in (None, "env://") and world_size is None
                and "RANK" not in os.environ):
            raise ValueError(
                "no process group: start one process per rank with torchrun "
                "(it sets RANK and WORLD_SIZE), or pass init_method, "
                "world_size and rank")
        kwargs = {}
        if world_size is not None:
            kwargs.update(world_size=world_size, rank=rank)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kwargs)
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return dist.get_rank(), dist.get_world_size()


@dataclass
class Mesh:
    """A (data, model) grid of ranks and this rank's place in it. data_group
    holds the ranks of this rank's model index (the 'data' axis), and
    model_group those of its data index; None where there is no process
    group (one rank). A Mesh built directly, without groups, describes a
    shape only (the eligibility gates)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[object] = field(default=None, repr=False)
    model_group: Optional[object] = field(default=None, repr=False)
    world_group: Optional[object] = field(default=None, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of the default process group's ranks; data=-1 takes the
    ranks the model axis leaves. data * model must be the world size (1
    without a process group). Every rank must call it, in the same order
    (the axes' groups are made collectively)."""
    n = device_count()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(
            f"mesh {data}x{model} does not match the world size {n}: start "
            "one process per device and initialise the process group "
            "(parallel.mesh.init_distributed, or torchrun)")
    if not dist.is_initialized():
        return Mesh(data, model)
    rank = dist.get_rank()
    world = dist.group.WORLD
    data_group = model_group = None
    for j in range(model):          # the 'data' axis: one group per column
        ranks = [i * model + j for i in range(data)]
        g = world if model == 1 else (
            dist.new_group(ranks) if data > 1 else None)
        if rank in ranks:
            data_group = g
    for i in range(data):           # the 'model' axis: one group per row
        ranks = [i * model + j for j in range(model)]
        g = world if data == 1 else (
            dist.new_group(ranks) if model > 1 else None)
        if rank in ranks:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group, world)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def split_bounds(total: int, parts: int) -> list:
    """Contiguous blocks of total units over parts: block i is [b[i],
    b[i + 1]) with b[i] = floor(i * total / parts), so the blocks differ
    by at most one unit and an even split gives equal ones."""
    return [i * total // parts for i in range(parts + 1)]


def _sizes(sizes, n):
    if sizes is not None and len(sizes) != n:
        raise ValueError(f"{len(sizes)} block sizes for {n} ranks")
    return None if sizes is None or len(set(sizes)) == 1 else list(sizes)


def gather_rows(x: torch.Tensor, group, sizes=None) -> torch.Tensor:
    """The group's x stacked along dim 0, in rank order (no gradient).
    sizes: every rank's row count where they differ (rank i's x has
    sizes[i] rows): each x is padded to the largest and the pad rows are
    dropped after the gather."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    sizes = _sizes(sizes, n)
    x = x.contiguous()
    if sizes is not None:
        m = max(sizes)
        pad = x.new_zeros((m,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        full = gather_rows(pad, group)
        return torch.cat([full[i * m:i * m + k] for i, k in enumerate(sizes)])
    if _nccl(group):
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def reduce_scatter_rows(x: torch.Tensor, group, sizes=None) -> torch.Tensor:
    """This rank's block of dim 0 of the group's sum of x (no gradient).
    sizes: every rank's block where they differ: each block is padded to
    the largest with zero rows before the reduce-scatter, and the pad rows
    of the result are dropped."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    sizes = _sizes(sizes, n)
    if sizes is not None:
        if x.shape[0] != sum(sizes):
            raise ValueError(f"{x.shape[0]} rows for blocks {sizes}")
        m = max(sizes)
        pad = x.new_zeros((n * m,) + tuple(x.shape[1:]))
        at = 0
        for i, k in enumerate(sizes):
            pad[i * m:i * m + k] = x[at:at + k]
            at += k
        return reduce_scatter_rows(pad, group)[:sizes[dist.get_rank(group)]]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    if _nccl(group):
        dist.reduce_scatter_tensor(out, x, group=group)
    else:   # gloo has the list form only
        dist.reduce_scatter(out, list(x.chunk(n)), group=group)
    return out


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x, in place (no gradient)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class AllGatherRows(torch.autograd.Function):
    """all_gather_rows with its gradient: the reduce-scatter (sum) of the
    cotangent, each rank's block of it."""

    @staticmethod
    def forward(ctx, x, group, sizes=None):
        ctx.group, ctx.sizes = group, sizes
        return gather_rows(x, group, sizes)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group, ctx.sizes), None, None


class AllReduceSum(torch.autograd.Function):
    """The group's sum of x, with its gradient: the group's sum of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_over(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.clone(), ctx.group), None


def all_gather_rows(x, group, sizes=None):
    return AllGatherRows.apply(x, group, sizes)


def all_reduce_sum(x, group):
    return AllReduceSum.apply(x, group)
