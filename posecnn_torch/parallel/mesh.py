"""Data and tensor parallelism over `torch.distributed`.

Counterpart of `posecnn_tpu/parallel/mesh.py`. JAX's data parallelism is
one SPMD program: the jitted step sees the global batch, and XLA inserts
the gradient psum. Here each rank is a process with its share of the
global batch, and the step computes JAX's global-batch step explicitly:

  * every loss term is (local numerator) / (normaliser summed over the
    data group), so the ranks' local totals sum to the global loss
    (`engine/train._compose_losses_from_outputs` with `loss_reduce`);
  * gradients are SUMMED over the data group in one flat bucket
    (`reduce_gradients`), which then equals the global-batch gradient;
  * the `max_pose_rois` cap keeps the rows the global cap keeps
    (`models/posecnn.global_pose_row_cap`), and the Hough rows' domain
    is the global batch's.

A (data × model) `Mesh` holds the grid of ranks, filled row-major as
`devices[:n].reshape(num_data, num_model)` fills JAX's, and one process
group per data column (ranks with one model index: they reduce the
gradients) and per model row (ranks with one data index: they share a
batch and split fc6/fc7). With a world of one, or a group of one rank,
every collective is the identity.

JAX's `batch_sharding` and `replicated` have no torch meaning: a rank
holds tensors, not sharded arrays. Their work, putting a rank's share of
a global batch on its device, is `data/pipeline.make_sharded_device_put`;
parameters are replicated by construction (every rank initialises from
one seed or restores one file).

`param_sharding(mesh, model, shard_fc=True)` is the tensor-parallel
option of `__graft_entry__.dryrun_multichip`: the pose head's fc6 and fc7
become column-parallel (`ColumnParallelLinear`). Model rank r holds rows
[r·F/M, (r+1)·F/M) of the torch (out, in) weight, the columns of the flax
kernel under `P(None, 'model')`; the bias stays whole, as JAX shards only
the 2-D kernels, and each rank adds its slice. The layer's input passes
through `copy_to_model` (identity forward, all-reduce backward: each rank
sends back only its slice's part of the input gradient) and its output
through `gather_from_model` (all-gather forward, the local slice
backward: fc8 onwards runs redundantly on every model rank, so a summing
backward would count its gradient M times). The bias's gradient is then
nonzero only on each rank's slice and is summed over the model group.

Collectives are those gloo offers on CUDA tensors too (all-reduce,
broadcast, all-gather), so a run of several ranks on one card works over
gloo as it does over NCCL on several.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

FC_LAYERS = ("fc6", "fc7")  # the pose head's layers `param_sharding` splits


@dataclass
class Mesh:
    """A (num_data, num_model) grid of ranks and this rank's place in it.
    `data_group` holds the ranks of this rank's column (one model index),
    `model_group` those of its row (one data index); both are None where
    no process group runs, and then every collective is the identity."""

    grid: np.ndarray  # (num_data, num_model) ranks, row-major
    rank: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    world_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        return {"data": self.grid.shape[0], "model": self.grid.shape[1]}

    @property
    def data_size(self) -> int:
        return self.grid.shape[0]

    @property
    def model_size(self) -> int:
        return self.grid.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size


def create_mesh(num_data: int = -1, num_model: int = 1, *, world: Optional[int] = None) -> Mesh:
    """Build a (data × model) mesh over the ranks (`mesh.py:29-48`).
    num_data=-1 takes every rank the model axis leaves. `world` defaults
    to the live process group's size (1 without one); the groups are made
    only where a process group runs, by every rank in the same order, as
    `new_group` requires."""
    live = dist.is_available() and dist.is_initialized()
    n = world if world is not None else (dist.get_world_size() if live else 1)
    if num_data == -1:
        if n % num_model != 0:
            raise ValueError(f"{n} devices not divisible by num_model={num_model}")
        num_data = n // num_model
    if num_data * num_model > n:
        raise ValueError(
            f"mesh {num_data}×{num_model} needs {num_data * num_model} devices, have {n}")
    grid = np.arange(num_data * num_model).reshape(num_data, num_model)
    mesh = Mesh(grid)
    if not live:
        return mesh
    mesh.rank = dist.get_rank()
    if mesh.rank >= grid.size:
        raise ValueError(f"rank {mesh.rank} is outside the {num_data}×{num_model} mesh")
    for m in range(num_model):
        group = dist.new_group(grid[:, m].tolist())
        if m == mesh.model_index:
            mesh.data_group = group
    for d in range(num_data):
        group = dist.new_group(grid[d].tolist())
        if d == mesh.data_index:
            mesh.model_group = group
    mesh.world_group = dist.group.WORLD
    return mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, backend: str = "gloo"):
    """`torch.distributed.init_process_group` at `coordinator_address`
    (an init method: `tcp://host:port` or `file:///path`); returns
    (rank, world). A no-op returning (0, 1) without an address
    (`mesh.py:86-104`)."""
    if coordinator_address is None:
        return 0, 1
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of `x` over `group`, without gradient; `x` itself on a group of
    one."""
    if _size(group) == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's `x`, in group-rank order,
    without gradient."""
    if _size(group) == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.stack(parts)


def any_rank(flag: bool, group, device) -> bool:
    """Whether `flag` is set on any rank of `group` (the flags summed)."""
    return bool(all_reduce_sum(torch.tensor([float(flag)], device=device), group) > 0)


def all_reduce_grads(params: Sequence[torch.Tensor], group) -> None:
    """Sum every parameter's gradient over `group`, in place, as one flat
    bucket per dtype. Every parameter must have a gradient tensor on
    every rank, or the buckets would not line up."""
    if _size(group) == 1:
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def loss_reduce(mesh: Optional[Mesh]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The sum over the data group that the loss normalisers and metrics
    take, or None (local) without a mesh or with one data rank."""
    if mesh is None or mesh.data_size == 1:
        return None
    return partial(all_reduce_sum, group=mesh.data_group)


def tp_partial_params(model: nn.Module) -> list:
    """The biases of the column-parallel layers: each model rank's
    gradient covers only its slice."""
    return [m.bias for m in model.modules() if isinstance(m, ColumnParallelLinear)]


def tp_sharded_params(model: nn.Module) -> list:
    """The weights of the column-parallel layers: one shard per model rank."""
    return [m.weight for m in model.modules() if isinstance(m, ColumnParallelLinear)]


def reduce_gradients(params: Sequence[torch.Tensor], mesh: Optional[Mesh],
                     partial_params: Sequence[torch.Tensor] = ()) -> None:
    """After `backward`: a zero gradient where there is none (a rank
    whose pose head got no rows still sends its bucket), the partial
    biases of `partial_params` summed over the model group, then every
    gradient summed over the data group. The sharded weights reduce over
    their data column only, which is this rank's data group."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is None:
        return
    if partial_params:
        all_reduce_grads(partial_params, mesh.model_group)
    all_reduce_grads(params, mesh.data_group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if grad.numel() == 0:
            return grad, None
        return all_reduce_sum(grad.contiguous(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last axis over the model group; the gradient
    of the local slice only."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        n = _size(group)
        if x.numel() == 0:  # every rank of a model group has the same rows
            return x.new_zeros(x.shape[:-1] + (n * x.shape[-1],))
        return torch.cat(list(all_gather(x, group)), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, index: int) -> torch.Tensor:
    return x if _size(group) == 1 else _GatherFromModel.apply(x, group, index)


class ColumnParallelLinear(nn.Module):
    """`nn.Linear` split by output rows over the model group: this rank's
    rows [lo, hi) of the (out, in) weight and the whole bias; `forward`
    returns the gathered (…, out) output, cast as the pose head casts
    (inputs and weights in `compute_dtype`)."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        out, m, r = linear.out_features, mesh.model_size, mesh.model_index
        if out % m:
            raise ValueError(f"{out} output features not divisible by num_model={m}")
        self.lo, self.hi = r * out // m, (r + 1) * out // m
        self.group, self.index = mesh.model_group, r
        self.weight = nn.Parameter(linear.weight.detach()[self.lo:self.hi].clone())
        self.bias = nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = copy_to_model(x, self.group)
        local = F.linear(x.to(dtype), self.weight.to(dtype), self.bias[self.lo:self.hi].to(dtype))
        return gather_from_model(local, self.group, self.index)


def param_sharding(mesh: Mesh, model: nn.Module, *, shard_fc: bool = False) -> nn.Module:
    """With `shard_fc` and a model axis, replace the pose head's fc6 and
    fc7 by column-parallel layers holding this rank's shard
    (`mesh.py:63-83`); otherwise every parameter stays replicated. Call
    it before the optimizer is made. Returns `model`."""
    if shard_fc and mesh.model_size > 1:
        for name in FC_LAYERS:
            setattr(model.pose_head, name, ColumnParallelLinear(getattr(model.pose_head, name),
                                                                mesh))
    return model


def shard_fc_state(state: dict, model_index: int, model_size: int) -> dict:
    """A full state dict with the pose head's fc6/fc7 weights cut to
    model rank `model_index`'s rows, as `ColumnParallelLinear` holds them."""
    out = dict(state)
    for name in FC_LAYERS:
        key = f"pose_head.{name}.weight"
        w = state[key]
        rows = w.shape[0] // model_size
        out[key] = w[model_index * rows:(model_index + 1) * rows].clone()
    return out


def gather_fc_state(shards: Sequence[dict]) -> dict:
    """The full state dict from the model ranks' states, in model-rank
    order: `shard_fc_state`'s inverse."""
    out = dict(shards[0])
    for name in FC_LAYERS:
        key = f"pose_head.{name}.weight"
        out[key] = torch.cat([s[key] for s in shards])
    return out


def _rank_entry(rank: int, fn, args, world: int, devices: Sequence[str], backend: str,
                init_file: str, num_threads: int):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if num_threads:
        torch.set_num_threads(num_threads)
    initialize_distributed(f"file://{init_file}", world, rank, backend=backend)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, args: tuple = (), *, devices: Sequence[str], backend: str,
                rendezvous_dir: str, num_threads: int = 0) -> None:
    """Run `fn(rank, device, *args)` in `nprocs` spawned processes joined
    in one process group (`backend` over a `file://` rendezvous in a fresh
    directory under `rendezvous_dir`, so concurrent runs cannot collide).
    Rank r runs on `devices[r]` (made current on a card), with
    `num_threads` torch threads if given. A rank that raises makes this
    raise, with its traceback (`torch.multiprocessing.spawn`)."""
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    os.makedirs(rendezvous_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="rendezvous_", dir=rendezvous_dir) as tmp:
        torch.multiprocessing.spawn(
            _rank_entry, args=(fn, args, nprocs, list(devices), backend,
                               os.path.join(tmp, "init"), num_threads),
            nprocs=nprocs, join=True)
