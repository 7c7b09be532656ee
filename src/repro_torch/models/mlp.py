"""Feed-forward variants: SwiGLU (qwen/chatglm/deepseek), GeGLU (gemma2),
plain GELU (starcoder2, musicgen).  The reference's ``gelu(approximate=
True)`` is torch's ``approximate="tanh"``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import CastParams, empty_param, param_init

KINDS = ("swiglu", "geglu", "gelu")


def mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """p: ``up``/``down`` (and ``gate`` for the gated kinds) in x's dtype."""
    up = x @ p["up"]
    if kind == "swiglu":
        h = F.silu(x @ p["gate"]) * up
    elif kind == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * up
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ p["down"]


class MLP(CastParams):
    """The reference's ``init_mlp`` parameters, (in, out) layout."""

    def __init__(self, d_model: int, d_ff: int, kind: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"mlp kind {kind!r} not in {KINDS}")
        self.kind = kind
        if kind in ("swiglu", "geglu"):
            self.gate = empty_param(d_model, d_ff, device=device, dtype=dtype)
        self.up = empty_param(d_model, d_ff, device=device, dtype=dtype)
        self.down = empty_param(d_ff, d_model, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            param_init(p, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.weights(x.dtype), x, self.kind)
