"""The exchanges of expert parallelism (``models.moe.moe_ffn_ep``) over a
(data D, model M) mesh of W = D x M ranks, rank d M + m at mesh
coordinate (d, m).

A comm runs some of the mesh's ranks in this process and takes one value
per such rank, as a list in rank order:

* :class:`LocalComm` holds all W ranks in one process (CPU tests, or M
  ranks on one card);
* :class:`DistComm` is one rank of a ``torch.distributed`` world, its list
  one entry long.

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

import torch
import torch.distributed as dist


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


__all__ = ["SOLO", "DistComm", "LocalComm", "Rank", "ScaleGrad", "cut_seq", "gather_seq",
           "reduce_seq"]
