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
"""
from __future__ import annotations

import torch

_KINDS = ("none", "fp16", "int8", "topk")


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
    def _quantise(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        if self.kind == "fp16":
            return x.half().to(x.dtype)
        if self.kind == "int8":
            scale = x.abs().max().clamp(min=1e-30) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127)
            return q * scale
        # topk: keep the largest-magnitude fraction of entries
        flat = x.reshape(-1).abs()
        k = max(1, int(self.topk_frac * flat.numel()))
        kth = torch.topk(flat, k).values[-1]
        return torch.where(x.abs() >= kth, x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))

    def encode_decode(self, grads, ef_state):
        """One compression round: (decompressed grads, new EF residuals)."""
        def one(g, ef):
            x = g.float() + ef
            d = self._quantise(x)
            return d.to(g.dtype), x - d

        pairs = _map(one, grads, ef_state)
        return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)

    def roundtrip(self, grads):
        """Stateless quantise->dequantise (ablation path in train_step)."""
        if self.kind == "none":
            return grads
        return _map(lambda g: self._quantise(g.float()).to(g.dtype), grads)

    # -------------------------------------------------------- accounting
    def traffic_ratio(self) -> float:
        """Bytes on the wire relative to uncompressed float32."""
        return {"none": 1.0, "fp16": 0.5, "int8": 0.25,
                "topk": 2.0 * self.topk_frac}[self.kind]


__all__ = ["Compressor"]
