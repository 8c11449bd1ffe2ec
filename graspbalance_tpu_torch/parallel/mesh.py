"""Process meshes and the collectives of data-parallel training (port of
graspbalance_tpu/parallel/mesh.py).

The JAX package trains SPMD over a ``Mesh(('data', 'point'))``: batch arrays
split on axis 0 over 'data', parameters replicated, and every reduction over
the batch (BatchNorm statistics, loss denominators, metrics) spanning the
whole batch, so that a mesh step computes what a one-device step computes.
Here each rank of a ``torch.distributed`` process group is one coordinate of
a ``DeviceMesh`` with the same two dims, holds its rows of the batch
(``shard_batch``), and within ``data_parallel(group)``:

  - ``nn.layers.BatchNorm`` in train mode sums x, x^2 and its row count over
    the group (``all_reduce_sum``, whose backward sums the cotangents too);
  - the losses divide each rank's own numerator by the denominator summed
    over the group (``global_sum``, ``global_mean``), so that the ranks'
    losses add up to the global-batch loss;
  - label matching rescales the scores by their maximum over the global
    batch (``global_max``).

The training steps then sum the gradients over 'data'
(``all_reduce_grads_``: a sum, not DDP's mean, because each rank's loss is
its share of the global loss) and the metrics (``all_reduce_metrics``).
Outside ``data_parallel``, or in a group of one rank, every function above
computes what the one-process code computes, bit for bit.

The backend is the caller's choice, made where it calls
``init_process_group`` (``init_from_env`` for the command lines): 'nccl'
when each rank owns a card, 'gloo' on the CPU or where ranks share one card
(NCCL refuses two ranks on one device). A gather is written as an
all-reduce sum into zero-filled per-rank slots (``gather_slots``), which
both backends run on CUDA tensors (torch's documentation lists no gloo
all-gather of them) and which is exact, since adding zeros is exact.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os

import torch
import torch.distributed as dist

AXES = ("data", "point")
TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer raises


def make_mesh(n_data: int | None = None, n_point: int = 1, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the default process group with dims ('data',
    'point'); ``n_data=None`` is the world size over ``n_point``. The mesh
    must cover the world: a rank outside it would have no rows."""
    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_point
    if n_data * n_point != world:
        raise ValueError(f"a ({n_data}, {n_point}) mesh needs {n_data * n_point} ranks; the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_data, n_point), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group along ``axis`` through this rank (None without a mesh)."""
    return None if mesh is None else mesh.get_group(axis)


def is_lead() -> bool:
    """True on the rank that writes the run's files (rank 0, or without a
    process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_rows(a, mesh):
    """This rank's rows of ``a`` (a numpy array or a tensor): its 'data'
    coordinate's equal share of axis 0, the same on every 'point' rank."""
    s = axis_size(mesh, "data")
    if s == 1:
        return a
    n = len(a)
    if n % s:
        raise ValueError(f"a batch of {n} rows does not split over {s} data ranks")
    r = axis_rank(mesh, "data")
    return a[r * n // s:(r + 1) * n // s]


def shard_batch(batch: dict, mesh) -> dict:
    """Every array of ``batch`` cut to this rank's rows (``shard_rows``)."""
    return {k: shard_rows(v, mesh) for k, v in batch.items()}


@torch.no_grad()
def replicate_(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank of ``mesh`` (which covers the process group), in place; returns
    ``module``. Without a mesh, or on a mesh of one rank, a no-op."""
    if mesh is not None and mesh.size() > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module


# the data group of the enclosing data_parallel(): None outside it or for a
# group of one rank (a context variable, so each thread has its own)
_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, BatchNorm and the losses reduce over ``group`` (a
    process group, or None); a group of one rank changes nothing."""
    token = _GROUP.set(group if group is not None and dist.get_world_size(group) > 1 else None)
    try:
        yield
    finally:
        _GROUP.reset(token)


def data_group():
    """The group of the enclosing ``data_parallel`` (None: reduce locally)."""
    return _GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the enclosing ``data_parallel`` group, without
    gradient (a denominator or a count); ``x`` itself outside it."""
    group = data_group()
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def global_max(x: torch.Tensor) -> torch.Tensor:
    """``x``'s largest value over the enclosing ``data_parallel`` group
    (elementwise), without gradient; ``x`` itself outside it."""
    group = data_group()
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the whole batch: its sum
    over the elements of every rank (``x.mean()`` outside
    ``data_parallel``)."""
    if data_group() is None:
        return x.mean()
    return x.sum() / global_sum(torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device))


@torch.no_grad()
def all_reduce_grads_(module: torch.nn.Module, group) -> None:
    """Sum every parameter's ``.grad`` over ``group`` in place (one
    collective over the gradients laid end to end)."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@torch.no_grad()
def all_reduce_metrics(metrics: dict, group) -> dict:
    """Each 0-dim metric, a rank's share, summed over ``group`` into the
    global value (in float64, so that counts stay exact), in its dtype."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
    dist.all_reduce(flat, group=group)
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, flat.unbind())}


def gather_slots(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` at its rank's slot, through an
    all-reduce sum of zero-filled slots (see the module docstring); exact
    for integers and floats."""
    slots = x.new_zeros((size,) + tuple(x.shape))
    slots[rank] = x
    dist.all_reduce(slots, group=group)
    return slots


def init_from_env(device="cuda"):
    """Under ``torchrun`` (RANK, WORLD_SIZE and LOCAL_RANK set), join its
    process group unless this process is in one already. Returns this
    rank's device, ``cuda:LOCAL_RANK`` for ``device='cuda'`` (backend
    'nccl': each rank owns a card) else ``device`` (backend 'gloo'), and
    whether it joined (the caller then leaves with
    ``torch.distributed.destroy_process_group``). Without those variables,
    or in a process group already: (``device`` as given, False)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device, False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT)
    return dev, True
