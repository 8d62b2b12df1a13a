"""The ("data", "model") mesh and the collectives of multi-device training.

Counterpart of mrfa_tpu/parallel/mesh.py (the reference's DDP over NCCL:
run.py:48-59, train.py:43-48). One process per device. The global batch is
split over the mesh's 'data' dimension and the parameters are replicated
over the whole world. The 'model' dimension splits each sample's
correlation queries (`models.raft.shard_queries`, the JAX package's
`maybe_constrain(c0, "data", "model", None)`): the ranks of a model group
hold the same rows, each builds and looks up its own contiguous block of
the queries, and the lookups are gathered back (`gather_rows`); the
features the blocks are built from pass through `group_copy`, whose
backward sums the partial cotangents over the group. The cross-replica
reductions that GSPMD inserts into the JAX step are explicit calls here
(`train.Trainer` makes them):
  - BatchNorm's batch statistics over the data group (`nn.norm.BatchNorm`,
    through `all_reduce_sum`, whose backward sums the cotangents);
  - the gradients, averaged over the world in one coalesced all_reduce
    before the clip (`average_gradients`);
  - the loss terms, averaged over the world (`average_scalars`), so every
    rank reports the global batch's.
The gradient average is a plain call rather than `DistributedDataParallel`:
the background predictor's parameters take part in bg steps only, and the
step stays "the gradient of the global-batch mean" with its clip and its two
optimizers as they are.
"""
from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mrfa_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this
    process's device: over NCCL on `cuda:LOCAL_RANK` for "cuda", over gloo
    on the CPU for "cpu"."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed run needs torchrun's environment; unset: {missing}")
    kind = torch.device(device).type
    if kind == "cuda":
        dev = resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: cuda or cpu")
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") `DeviceMesh` over the initialized world, which
    must hold exactly n_data * n_model ranks (n_data: the world over
    n_model when None). Rank r sits at (r // n_model, r % n_model): the data
    index is the slow one, as in the JAX mesh's reshape(n_data, n_model)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        if n_model < 1 or world % n_model:
            raise ValueError(f"{world} ranks do not split over n_model={n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs a world of {n_data * n_model}, "
                         f"not {world}")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_shard(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(this rank's index, the count) along the mesh's data dimension; (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def model_shard(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(this rank's index, the count) along the mesh's model dimension; (0,
    1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(MODEL_AXIS), mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))


def shard_rows(x, index: int, count: int):
    """Slice `index` of `count` equal slices of the leading axis of `x`."""
    rows = x.shape[0]
    if rows % count:
        raise ValueError(f"{rows} rows do not split over {count} ranks")
    per = rows // count
    return x[index * per:(index + 1) * per]


def shard_batch(batch: Dict[str, Any], mesh: Optional[DeviceMesh]) -> Dict[str, Any]:
    """This rank's rows of a global host batch (each value's leading axis)."""
    index, count = data_shard(mesh)
    return {k: shard_rows(v, index, count) for k, v in batch.items()}


def _coalesced(tensors: Iterable[torch.Tensor], op: Callable[[torch.Tensor], None]) -> None:
    """`op` on one flat buffer per dtype holding `tensors`, copied back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        for t, chunk in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(chunk.view_as(t))


def replicated(module: nn.Module) -> nn.Module:
    """`module` with its parameters and buffers broadcast from global rank 0
    to every rank of the world, so that every rank starts from the same
    replica."""
    with torch.no_grad():
        _coalesced([*module.parameters(), *module.buffers()],
                   lambda flat: dist.broadcast(flat, src=0))
    return module


def average_gradients(params: Iterable[nn.Parameter], group) -> None:
    """Replace each existing `.grad` by its mean over `group`: one all_reduce
    of them all, then a division by the group's size."""
    world = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _coalesced([p.grad for p in params if p.grad is not None], mean)


def average_scalars(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The 0-d tensors of `values` averaged over `group` in one all_reduce
    (in their promoted dtype), each in its own dtype."""
    dtype = functools.reduce(torch.promote_types, [v.dtype for v in values.values()])
    flat = torch.stack([v.detach().to(dtype) for v in values.values()])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return {k: m.to(v.dtype) for (k, v), m in zip(values.items(), flat)}


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the cotangents over it too: each
    rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of `x` over `group`."""
    return _AllReduceSum.apply(x, group)


class _GroupCopy(torch.autograd.Function):
    """Identity whose backward sums the cotangents over a group: a value
    each rank of the group holds whole and uses for its own share of the
    work, so that each rank's cotangent is partial."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def group_copy(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, with the cotangents of its uses on every rank of `group` summed."""
    return _GroupCopy.apply(x, group)


class _GatherRows(torch.autograd.Function):
    """Each rank's (B, n, C) block, gathered along the second axis in the
    group's rank order into (B, M n, C); the backward keeps this rank's
    block of the cotangent, which every rank computes whole."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        index, count = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        per = grad.shape[1] // count
        return grad[:, index * per:(index + 1) * per], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable gather of every rank's (B, n, C) `x` of `group`
    into (B, M n, C), rank 0's rows first."""
    return _GatherRows.apply(x, group)
