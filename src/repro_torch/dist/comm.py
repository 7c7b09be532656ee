"""The exchanges of expert parallelism (``models.moe.moe_ffn_ep``) over a
(data D, model M) mesh of W = D x M ranks, rank d M + m at mesh
coordinate (d, m).

A comm runs some of the mesh's ranks in this process and takes one value
per such rank, as a list in rank order:

* :class:`LocalComm` holds all W ranks in one process (CPU tests, or M
  ranks on one card);
* :class:`DistComm` is one rank of a ``torch.distributed`` world, its list
  one entry long;
* :class:`CountComm` is one rank of a W-rank mesh inside this process with
  no peers (the dry-run, ``launch.dryrun``): each collective returns a
  result of the right shape (values unset: meant for the meta device) and
  records its operand bytes by op and mesh axis with the active counter
  (``roofline.count``), in the forward and in the backward.

Both give the reference's collectives of ``moe_ffn_ep``: ``all_to_all``
over the "model" axis (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``)
and ``all_mean`` over every rank (``jax.lax.pmean`` over all mesh axes),
and those of tensor and sequence parallelism over the M ranks of a data
row (``repro_torch.dist.tp``): ``gather`` (an all-gather along a dim),
``scatter_sum`` (a reduce-scatter along a dim), ``sum`` (an all-reduce)
and ``max`` (an all-reduce of the maximum, not differentiated).

Each differentiates as the sum of every rank's loss: the adjoint of an
all-to-all is the reverse all-to-all, that of a mean over ranks is the
mean of the ranks' gradients, that of an all-gather a reduce-scatter (and
back), and that of an all-reduce an all-reduce.  A mean is taken over the
ranks' values stacked in rank order (gathered, where the ranks are
processes), never in a collective's own summation order, so both comms
give the same bits.  The sums of tensor parallelism are the backend's own
(NCCL's order on the card): they agree with ``LocalComm``'s rank-order
sums to rounding.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..roofline import count


class LocalComm:
    """W = ``data`` x ``model`` ranks in this process; plain tensor ops, so
    autograd differentiates them itself."""

    def __init__(self, data: int = 1, model: int = 1):
        self.data, self.model = data, model
        self.ranks = data * model

    def _check(self, xs: list) -> None:
        if len(xs) != self.ranks:
            raise ValueError(f"LocalComm({self.data} x {self.model}) takes "
                             f"{self.ranks} values, got {len(xs)}")

    def all_to_all(self, xs: list) -> list:
        """xs[r]: (M, ...), block j bound for model rank j of r's data row;
        returns, per rank, the M blocks sent to it, in sender order."""
        self._check(xs)
        m = self.model
        return [torch.stack([xs[r - r % m + j][r % m] for j in range(m)])
                for r in range(self.ranks)]

    def all_mean(self, xs: list) -> list:
        """The mean over all W ranks, on every rank."""
        self._check(xs)
        return list(_LocalMean.apply(*xs))

    def _rows(self, xs: list) -> list:
        self._check(xs)
        return [xs[i:i + self.model] for i in range(0, self.ranks, self.model)]

    def gather(self, xs: list, dim: int) -> list:
        """Each rank's tensor concatenated along ``dim`` over its data row,
        on every rank of the row."""
        out = []
        for row in self._rows(xs):
            full = torch.cat(row, dim) if len(row) > 1 else row[0]
            out += [full] * len(row)
        return out

    def scatter_sum(self, xs: list, dim: int) -> list:
        """The sum over the data row, split along ``dim``: model rank m gets
        chunk m."""
        out = []
        for row in self._rows(xs):
            out += list(_row_sum(row).chunk(len(row), dim))
        return out

    def sum(self, xs: list) -> list:
        """The sum over the data row, on every rank of it."""
        out = []
        for row in self._rows(xs):
            out += [_row_sum(row)] * len(row)
        return out

    def max(self, xs: list) -> list:
        """The elementwise maximum over the data row (no gradient)."""
        out = []
        for row in self._rows(xs):
            out += [torch.stack([x.detach() for x in row]).amax(0)] * len(row)
        return out


def _row_sum(row: list) -> torch.Tensor:
    total = row[0]
    for x in row[1:]:
        total = total + x
    return total


class _LocalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        mean = torch.stack(xs).mean(0)
        return tuple(mean.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *grads):
        mean = torch.stack(grads).mean(0)
        return tuple(mean.clone() for _ in grads)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


def _gathered_mean(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts).mean(0)


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gathered_mean(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gathered_mean(grad, ctx.group), None


def _gather_along(x, dim: int, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


# torch 2.13 renames reduce_scatter_tensor (same signature)
_reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)


def _scatter_along(x, dim: int, group):
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    _reduce_scatter(out, xs, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_along(grad, ctx.dim, ctx.group), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_along(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_along(grad, ctx.dim, ctx.group), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class DistComm:
    """This process's rank: ``model_group`` holds the M ranks of its data
    row, in model order; ``world_group`` (None: the default group) all W.
    NCCL between cards, gloo on the CPU: whatever backend the groups
    have."""

    ranks = 1

    def __init__(self, model_group, world_group=None):
        self.group, self.world = model_group, world_group
        self.model = dist.get_world_size(model_group)

    def gather(self, xs: list, dim: int) -> list:
        (x,) = xs
        return [_Gather.apply(x, dim % x.dim(), self.group) if self.model > 1 else x]

    def scatter_sum(self, xs: list, dim: int) -> list:
        (x,) = xs
        return [_ScatterSum.apply(x, dim % x.dim(), self.group) if self.model > 1 else x]

    def sum(self, xs: list) -> list:
        (x,) = xs
        return [_Sum.apply(x, self.group) if self.model > 1 else x]

    def max(self, xs: list) -> list:
        (x,) = xs
        out = x.detach().clone()
        if self.model > 1:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return [out]

    def all_to_all(self, xs: list) -> list:
        (x,) = xs
        return [_AllToAll.apply(x, self.group)]

    def all_mean(self, xs: list) -> list:
        (x,) = xs
        return [_AllMean.apply(x, self.world)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _resized(x: torch.Tensor, dim: int, factor: float) -> torch.Tensor:
    if factor == 1:
        return x.new_empty(x.shape)
    shape = list(x.shape)
    shape[dim] = int(shape[dim] * factor)
    return x.new_empty(shape)


class _Counted(torch.autograd.Function):
    """A collective counted, not run: ``fwd``/``bwd`` are (op, factor)
    pairs, the output's ``dim`` scaled by factor (1: same shape)."""

    @staticmethod
    def forward(ctx, x, dim, fwd, bwd, axis):
        ctx.dim, ctx.bwd, ctx.axis = dim, bwd, axis
        op, factor = fwd
        out = _resized(x, dim, factor)
        count.collective(op, axis, _nbytes(x), _nbytes(out))
        return out

    @staticmethod
    def backward(ctx, grad):
        op, factor = ctx.bwd
        out = _resized(grad, ctx.dim, factor)
        count.collective(op, ctx.axis, _nbytes(grad), _nbytes(out))
        return out, None, None, None, None


class CountComm:
    """This process's one rank of a mesh (``launch.mesh.MeshSpec``) with no
    peers: every collective returns a tensor of its result's shape and
    counts its operand bytes on its axes (the data row's "model" axis, or
    every axis for ``all_mean``), in the forward and, through autograd, in
    the backward: an all-gather's adjoint is a reduce-scatter, an
    all-reduce's an all-reduce, an all-to-all's an all-to-all."""

    ranks = 1

    def __init__(self, mesh):
        self.mesh = mesh
        self.model = mesh.axis_size("model")
        self.data = mesh.chips // self.model
        self.world_axes = ",".join(mesh.axis_names)

    def _one(self, xs, dim, fwd, bwd, axis="model"):
        (x,) = xs
        if self.model == 1 and axis == "model":
            return [x]
        return [_Counted.apply(x, dim % max(1, x.dim()), fwd, bwd, axis)]

    def gather(self, xs: list, dim: int) -> list:
        return self._one(xs, dim, ("all-gather", self.model),
                         ("reduce-scatter", 1 / self.model))

    def scatter_sum(self, xs: list, dim: int) -> list:
        return self._one(xs, dim, ("reduce-scatter", 1 / self.model),
                         ("all-gather", self.model))

    def sum(self, xs: list) -> list:
        return self._one(xs, 0, ("all-reduce", 1), ("all-reduce", 1))

    def max(self, xs: list) -> list:
        (x,) = xs
        out = x.detach().clone()
        if self.model > 1:
            count.collective("all-reduce", "model", _nbytes(x), _nbytes(x))
        return [out]

    def all_to_all(self, xs: list) -> list:
        return self._one(xs, 0, ("all-to-all", 1), ("all-to-all", 1))

    def all_mean(self, xs: list) -> list:
        if math.prod(self.mesh.shape) == 1:
            return list(xs)
        return self._one(xs, 0, ("all-reduce", 1), ("all-reduce", 1), self.world_axes)


@dataclasses.dataclass(frozen=True)
class Rank:
    """A module's place in its data row: the row's "model" comm, this
    rank's model coordinate ``m`` of ``M`` and the mesh's rules."""
    comm: object
    m: int = 0
    M: int = 1
    rules: dict = dataclasses.field(default=None, compare=False, hash=False)


# an unsharded model: one rank, every collective over "model" the identity
SOLO = Rank(LocalComm(1, 1))


def gather_seq(comm, xs: list, sp: bool) -> list:
    """Before a column-parallel product: the whole sequence from its
    shards (with ``sp``; else the stream is whole already)."""
    return comm.gather(xs, 1) if sp else xs


def reduce_seq(comm, xs: list, sp: bool) -> list:
    """After a row-parallel product: the sum over "model", reduce-scattered
    onto the sequence shards with ``sp``, else on every rank."""
    return comm.scatter_sum(xs, 1) if sp else comm.sum(xs)


def cut_seq(xs: list, ranks: list, sp: bool) -> list:
    """Where every rank holds a whole-sequence result (a leaf whole over
    "model", or columns gathered): each rank's own sequence shard with
    ``sp``, else the results as they are."""
    if not sp:
        return xs
    return [x.chunk(r.M, 1)[r.m] for x, r in zip(xs, ranks)]


class ScaleGrad(torch.autograd.Function):
    """The identity whose gradient is scaled by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.c, None


__all__ = ["SOLO", "CountComm", "DistComm", "LocalComm", "Rank", "ScaleGrad", "cut_seq", "gather_seq",
           "reduce_seq"]
