"""AdamW + schedules + global-norm clipping (the reference's
``repro.optim.adamw`` over the model's named parameters).

The state is ``{"m": {name: tensor}, "v": {name: tensor}, "count": int32
scalar}``: m and v in each parameter's dtype on its device, the count on
the CPU.  The learning rate and the bias corrections are computed in
float32, as ``jnp`` computes them (Python's float64 arithmetic gives other
last bits), and every update follows the reference's order of operations,
so a step on the same parameters and gradients agrees with it to float32
rounding.  ``convert.opt_state_to_reference`` carries the state into the
reference's layout and back.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..convert import _reference_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # 'cosine' | 'linear' | 'constant'
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: a float32 scalar on the CPU."""
    step = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.tensor(1.0, dtype=torch.float32)
    return cfg.lr * warm * decay


def init_state(params: dict[str, torch.Tensor]) -> dict:
    return {"m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def _decay_mask(path, ndim: int) -> bool:
    """True if this leaf gets weight decay (the reference's rule on its
    pytree path): matrices only, and never the norm / scale / bias /
    lattice-constant leaves."""
    if ndim < 2:
        return False
    name = "/".join(path)
    leaf = path[-1] if path else ""
    if leaf in ("u", "w0", "mix", "dt_bias", "a_log", "d_skip", "conv_b",
                "count", "ln_scale"):
        return False
    for frag in ("norm", "scale", "bias"):
        if frag in name:
            return False
    return True


def decays(name: str, ndim: int) -> bool:
    """Whether the port parameter ``name`` of ``ndim`` dims is decayed.

    The reference decides on its own pytree path and on the *stacked*
    leaf's ndim (ROADMAP F7): a per-layer vector there is (L, n), two
    dims, so e.g. starcoder2's q/k/v biases are decayed.  The port takes
    the reference's path of the parameter (``convert._reference_path``)
    and its ndim plus one where that path is stacked."""
    path, layer = _reference_path(name)
    return _decay_mask(path, ndim + (layer is not None))


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], opt_state: dict,
                  grads: dict[str, torch.Tensor], cfg: AdamWConfig, step):
    """One AdamW step, in place on ``params`` and the state's m and v.
    Returns (params, opt_state, {"grad_norm", "lr"})."""
    gn = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
        grads = {n: g * scale.to(g.dtype) for n, g in grads.items()}
    lr_t = schedule_lr(cfg, step)
    lr = lr_t.item()
    count = opt_state["count"] + 1
    c1 = (1.0 - cfg.b1 ** count.float()).item()
    c2 = (1.0 - cfg.b2 ** count.float()).item()
    for name, p in params.items():
        g32 = grads[name].float()
        m, v = opt_state["m"][name], opt_state["v"][name]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if cfg.weight_decay and decays(name, p.dim()):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gn, "lr": lr_t}


__all__ = ["AdamWConfig", "apply_updates", "decays", "global_norm", "init_state",
           "schedule_lr"]
