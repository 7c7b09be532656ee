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
and ``all_mean`` over every rank (``jax.lax.pmean`` over all mesh axes).
Each differentiates as the sum of every rank's loss: the adjoint of an
all-to-all is the reverse all-to-all, and that of a mean over ranks is the
mean of the ranks' gradients.  A mean is taken over the ranks' values
stacked in rank order (gathered, where the ranks are processes), never in
a collective's own summation order, so both comms give the same bits.
"""
from __future__ import annotations

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


class DistComm:
    """This process's rank: ``model_group`` holds the M ranks of its data
    row, in model order; ``world_group`` (None: the default group) all W.
    NCCL between cards, gloo on the CPU: whatever backend the groups
    have."""

    ranks = 1

    def __init__(self, model_group, world_group=None):
        self.group, self.world = model_group, world_group
        self.model = dist.get_world_size(model_group)

    def all_to_all(self, xs: list) -> list:
        (x,) = xs
        return [_AllToAll.apply(x, self.group)]

    def all_mean(self, xs: list) -> list:
        (x,) = xs
        return [_AllMean.apply(x, self.world)]


__all__ = ["DistComm", "LocalComm"]
