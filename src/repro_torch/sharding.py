"""Sharding context: one object carries the mesh and its axes through the
model code.

The port of the JAX package's ``repro.sharding``.  Axes:

  dp  data parallel, ("pod", "data") on the multi-pod mesh: the batch, and
      with ``fsdp`` the parameters and the optimizer state (ZeRO-3);
  tp  tensor and expert parallel, "model".

A spec is a tuple with one entry per tensor dimension: None, a mesh axis
name, or a tuple of names sharding one dimension over several mesh
dimensions (major first), so it compares entry by entry with the
reference's ``PartitionSpec``.  ``placements(spec, axis_names)`` gives the
same layout as DTensor placements (``Shard`` / ``Replicate``), one per mesh
dimension.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over running
ranks, or a ``MeshShape`` (axis names and sizes, no ranks: the counterpart
of ``jax.sharding.AbstractMesh``), on which the spec builders work alone.
The model code runs on each rank's local shards (SPMD): ``shard(x, spec)``
is the identity without a mesh and cuts a tensor that every rank holds
whole to this rank's shard; the tensor-parallel regions are entered and
left through ``copy_to_tp`` / ``reduce_from_tp`` (Megatron's f and g),
``scatter_to_tp`` / ``gather_from_tp`` and ``reduce_partial``, autograd
functions over PyTorch's functional collectives.  The convention: a tensor
that is replicated over tp holds the same value, and receives the same
gradient, on every tp rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclass(frozen=True)
class MeshShape:
    """Mesh axes and their sizes, without ranks or devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """axis name -> size of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(entry: Axis) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[Axis], names: Sequence[str]) -> List[Any]:
    """DTensor placements of ``spec`` over a mesh with axes ``names``: mesh
    dimension a is ``Shard(d)`` where tensor dimension d's entry names a,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in axis_names(entry):
            out[list(names).index(a)] = Shard(dim)
    return out


def local_shape(shape: Sequence[int], spec: Sequence[Axis],
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    """A shard's shape under ``spec`` (dimensions divided by the product of
    their axes' sizes, rounded up as DTensor's first shards are)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // math.prod(sizes[a] for a in axis_names(e)))
                 for n, e in zip(shape, spec))


@dataclass(frozen=True)
class MeshContext:
    mesh: Optional[Any] = None  # a DeviceMesh, a MeshShape, or None
    dp: Tuple[str, ...] = ()  # data-parallel mesh axes (batch / fsdp)
    tp: Optional[str] = None  # tensor-parallel mesh axis
    fsdp: bool = True  # shard params + optimizer state over dp

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return int(mesh_shape(self.mesh)[self.tp])

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        sizes = mesh_shape(self.mesh)
        return math.prod(int(sizes[a]) for a in self.dp)

    # ---- spec builders -------------------------------------------------
    def dp_axis(self) -> Axis:
        return self.dp if self.dp else None

    def fsdp_axis(self) -> Axis:
        return self.dp if (self.fsdp and self.dp) else None

    def tp_axis(self) -> Axis:
        return self.tp

    def batch_spec(self, batch: int, extra_dims: int = 1) -> Spec:
        """Spec for [B, ...] activations: B over dp when it divides,
        otherwise unsharded (long-context decode with batch 1)."""
        if self.dp and batch % max(self.dp_size, 1) == 0:
            return (self.dp,) + (None,) * extra_dims
        return (None,) * (1 + extra_dims)

    def seq_shard_ok(self, batch: int) -> bool:
        """True when the batch cannot use dp and the sequence is sharded
        instead."""
        return bool(self.dp) and batch % max(self.dp_size, 1) != 0

    # ---- ranks ---------------------------------------------------------
    @property
    def has_ranks(self) -> bool:
        return self.mesh is not None and not isinstance(self.mesh, MeshShape)

    def coordinate(self, entry: Axis) -> Tuple[int, int]:
        """(index, count) of this rank's shard along a dimension whose spec
        entry is ``entry`` (major axis first)."""
        index, count = 0, 1
        for a in axis_names(entry):
            n = mesh_shape(self.mesh)[a]
            index = index * n + self.mesh.get_local_rank(a)
            count *= n
        return index, count

    def shard(self, x: torch.Tensor, spec: Sequence[Axis]) -> torch.Tensor:
        """This rank's shard of x, which every rank holds whole (the
        identity without a mesh of ranks): each dimension cut by its spec
        entry's axes, major first."""
        if not self.has_ranks:
            return x
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            index, count = self.coordinate(entry)
            size = -(-x.shape[dim] // count)
            x = x.narrow(dim, min(index * size, x.shape[dim]),
                         max(0, min(size, x.shape[dim] - index * size)))
        return x

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def tp_rank(self) -> int:
        return self.mesh.get_local_rank(self.tp) if self.tp_size > 1 else 0


# the reference's name for it
ShardCtx = MeshContext


def single_device_ctx() -> MeshContext:
    return MeshContext(mesh=None, dp=(), tp=None, fsdp=False)


def ctx_for_mesh(mesh: Any) -> MeshContext:
    names = tuple(mesh_shape(mesh))
    if "pod" in names:
        return MeshContext(mesh=mesh, dp=("pod", "data"), tp="model")
    if "data" in names:
        return MeshContext(mesh=mesh, dp=("data",), tp="model")
    return MeshContext(mesh=mesh, dp=(), tp=names[-1] if names else None)


# ---------------------------------------------------------------------------
# functional collectives over one process group
# ---------------------------------------------------------------------------
def _wait(t: torch.Tensor) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(t)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return _wait(torch.ops._c10d_functional.all_reduce(x.contiguous(), op, group.group_name))


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in rank order."""
    n = group.size()
    moved = x.movedim(dim, 0).contiguous()
    out = _wait(torch.ops._c10d_functional.all_gather_into_tensor(moved, n, group.group_name))
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, rank * size, size).contiguous()


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: the identity, whose gradient is summed over tp (the
    input is replicated; its consumers hold shards)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the sum of the ranks' partial values, whose gradient
    passes through (the sum is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReducePartial(torch.autograd.Function):
    """The sum of partial values that shard-holding consumers use: the sum
    forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFromTP(torch.autograd.Function):
    """Shards -> the whole tensor, replicated; the gradient is this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, group.size()
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.rank, ctx.n), None, None, None


class _ScatterToTP(torch.autograd.Function):
    """A replicated tensor -> this rank's slice; the gradient is gathered."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, rank, group.size())

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None, None


def _tp(ctx: Optional[MeshContext]) -> bool:
    return ctx is not None and ctx.has_ranks and ctx.tp_size > 1


def copy_to_tp(x: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    return _CopyToTP.apply(x, ctx.group(ctx.tp)) if _tp(ctx) else x


def reduce_from_tp(x: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    return _ReduceFromTP.apply(x, ctx.group(ctx.tp)) if _tp(ctx) else x


def reduce_partial(x: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    return _ReducePartial.apply(x, ctx.group(ctx.tp)) if _tp(ctx) else x


def gather_from_tp(x: torch.Tensor, dim: int, ctx: Optional[MeshContext]) -> torch.Tensor:
    if not _tp(ctx):
        return x
    return _GatherFromTP.apply(x, dim % x.dim(), ctx.group(ctx.tp), ctx.tp_rank())


def scatter_to_tp(x: torch.Tensor, dim: int, ctx: Optional[MeshContext]) -> torch.Tensor:
    if not _tp(ctx):
        return x
    return _ScatterToTP.apply(x, dim % x.dim(), ctx.group(ctx.tp), ctx.tp_rank())


def tp_max(x: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    """The elementwise maximum over tp (no gradient)."""
    return all_reduce(x.detach(), ctx.group(ctx.tp), "max") if _tp(ctx) else x.detach()
