"""Gradient compression with error feedback (the reference's
``repro.dist.compress`` over dicts of tensors).

Kinds:

* ``none`` — identity (traffic ratio 1.0),
* ``fp16`` — cast to half precision (0.5),
* ``int8`` — per-leaf symmetric linear quantisation (0.25),
* ``topk`` — keep the largest-|g| fraction per leaf (2 * topk_frac: values
  + indices on the wire).

``encode_decode`` implements the error-feedback (EF) transform: the
quantisation residual is carried in a state dict and added back before the
next round, so the ACCUMULATED decompressed signal tracks the accumulated
true gradient with bounded error.  ``torch.round``, as ``jnp.round``,
rounds half to even.  A tree is a dict of tensors, nested or not.

The reference compresses its parameter pytree's leaves, a stacked group
(every layer of it) being one leaf: int8's scale is max|x| over the leaf
and top-k's threshold the k-th largest |x| of the leaf.  The port's
parameters are one tensor a layer (and, across ranks, each rank holds
shards of them), so the train step takes each leaf's statistic with
:meth:`Compressor.leaf_stats` (over the layers of a stacked group, and
over every rank: a max all-reduce, the leaf gathered for top-k), and
``roundtrip``/``encode_decode`` take it (``stats``, a flat dict by
parameter name) in place of each tensor's own; error-feedback state is
then kept per shard, shaped like the rank's gradients.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_KINDS = ("none", "fp16", "int8", "topk")


def _shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


class Compressor:
    def __init__(self, kind: str = "none", topk_frac: float = 0.1):
        assert kind in _KINDS, f"unknown compression kind {kind!r}"
        self.kind = kind
        self.topk_frac = topk_frac

    # ------------------------------------------------------------- state
    def init(self, grads):
        """Zero error-feedback residuals shaped like the gradients."""
        return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)

    # ----------------------------------------------------------- encode
    def stat(self, x: torch.Tensor):
        """The leaf-wide statistic ``_quantise`` reads: int8's max|x|,
        top-k's k-th largest |x| (None for the other kinds)."""
        if self.kind == "int8":
            return x.abs().max()
        if self.kind == "topk":
            flat = x.reshape(-1).abs()
            return torch.topk(flat, max(1, int(self.topk_frac * flat.numel()))).values[-1]
        return None

    def _quantise(self, x: torch.Tensor, stat=None) -> torch.Tensor:
        """``stat``: the whole leaf's (``stat``), where ``x`` is a shard."""
        if self.kind == "none":
            return x
        if self.kind == "fp16":
            return x.half().to(x.dtype)
        if stat is None:
            stat = self.stat(x)
        if self.kind == "int8":
            scale = stat.clamp(min=1e-30) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127)
            return q * scale
        # topk: keep the largest-magnitude fraction of entries
        return torch.where(x.abs() >= stat, x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    def leaf_stats(self, grads: dict, place=None) -> dict | None:
        """{parameter name: the statistic of its reference leaf} for a
        model's gradients by parameter name (DTensors where FSDP shards
        them).  The reference compresses its pytree's leaves, and a
        stacked group's leaf holds every layer (``convert.
        _reference_path``): int8's scale and top-k's threshold are taken
        over all of its layers.  Across ranks (``place``: the model's
        ``dist.zero.Placement``) int8's maxima go through one max
        all-reduce over every rank (replicas hold equal values) and top-k
        gathers each leaf whole (``place.full``; every rank calls, in one
        order).  None for the kinds without a statistic."""
        if self.kind not in ("int8", "topk"):
            return None
        from ..convert import _reference_path

        groups: dict = {}
        for name in grads:
            groups.setdefault(_reference_path(name)[0], []).append(name)
        if self.kind == "int8":
            local = torch.stack([torch.stack([_shard(grads[n]).float().abs().max()
                                              for n in names]).max()
                                 for names in groups.values()])
            if place is not None:
                dist.all_reduce(local, op=dist.ReduceOp.MAX, group=place.world.get_group())
            return {n: local[i] for i, names in enumerate(groups.values()) for n in names}
        out = {}
        for names in groups.values():
            whole = [grads[n] if place is None else place.full(n, grads[n]) for n in names]
            stat = self.stat(torch.cat([g.float().reshape(-1) for g in whole]))
            out.update({n: stat for n in names})
        return out

    def encode_decode(self, grads, ef_state, stats: dict | None = None):
        """One compression round: (decompressed grads, new EF residuals);
        ``stats``: each leaf's whole-leaf statistic (flat dicts)."""
        def one(g, ef, stat=None):
            x = g.float() + ef
            d = self._quantise(x, stat)
            return d.to(g.dtype), x - d

        pairs = (_map(one, grads, ef_state) if stats is None else
                 {n: one(g, ef_state[n], stats[n]) for n, g in grads.items()})
        return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)

    def roundtrip(self, grads, stats: dict | None = None):
        """Stateless quantise->dequantise (ablation path in train_step);
        ``stats`` as :meth:`encode_decode`'s."""
        if self.kind == "none":
            return grads
        if stats is not None:
            return {n: self._quantise(g.float(), stats[n]).to(g.dtype)
                    for n, g in grads.items()}
        return _map(lambda g: self._quantise(g.float()).to(g.dtype), grads)

    # -------------------------------------------------------- accounting
    def traffic_ratio(self) -> float:
        """Bytes on the wire relative to uncompressed float32."""
        return {"none": 1.0, "fp16": 0.5, "int8": 0.25,
                "topk": 2.0 * self.topk_frac}[self.kind]


__all__ = ["Compressor"]
