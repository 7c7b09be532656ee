"""Shared building blocks: norms, rotary, softcap, init.

Plain functions on tensors, as in the reference's ``repro.models.layers``.
The reference's ``shard`` is the identity on one device
(``repro/dist/sharding.py:116-131``); the port has no counterpart.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn


def empty_param(*shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """An uninitialised parameter (inference only: no gradient)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


@torch.no_grad()
def param_init(p: torch.Tensor, generator: torch.Generator,
               scale: float = 0.02) -> None:
    """Fill ``p`` with ``scale`` x unit normal draws from ``generator``."""
    p.normal_(0.0, 1.0, generator=generator).mul_(scale)


class CastParams(nn.Module):
    """A module whose parameters stay in the parameter dtype and are read
    in the compute dtype, as the reference's ``p[...].astype(dt)``.  The
    cast copy is made at the first read and kept: the model is inference
    only, and its weights are set (init or ``convert``) before that read."""

    def cast(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        p = getattr(self, name)
        if p.dtype == dtype:
            return p
        cache = self.__dict__.setdefault("_cast_cache", {})
        if (name, dtype) not in cache:
            cache[(name, dtype)] = p.to(dtype)
        return cache[(name, dtype)]

    def weights(self, dtype: torch.dtype, keep=()) -> dict[str, torch.Tensor]:
        """This module's own parameters by name, in ``dtype``; those named
        in ``keep`` as they are (the reference reads them in float32 from
        the parameter dtype, not through the compute dtype)."""
        return {name: p if name in keep else self.cast(name, dtype)
                for name, p in self._parameters.items()}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:  # gemma convention: weight initialised at 0, used as 1 + w
        w = 1.0 + w
    return (y * w).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# Rotary position embeddings (NeoX rotate-half convention, partial fraction)
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, fraction: float, theta: float):
    """(rotated dims, inverse frequencies as float32 numpy); computed in
    float64 and cast, as the reference does."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return rot, inv.astype(np.float32)


@lru_cache(maxsize=None)
def _inv_frequencies(head_dim: int, fraction: float, theta: float,
                     device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, copied there once: a copy
    from host memory per call would wait for the device every layer."""
    return torch.as_tensor(rope_frequencies(head_dim, fraction, theta)[1],
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float = 1.0,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    rot = rope_frequencies(d, fraction, theta)[0]
    if rot == 0:
        return x
    inv = _inv_frequencies(d, fraction, theta, x.device)
    angles = positions[..., None].float() * inv          # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin                             # float32, as in JAX
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1)
    if rot < d:
        out = torch.cat([out, xp.to(out.dtype)], dim=-1)
    return out.to(x.dtype)


__all__ = ["CastParams", "apply_rope", "empty_param", "param_init",
           "rms_norm", "rope_frequencies", "softcap"]
