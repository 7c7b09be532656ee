"""Fine-grained Mixture-of-Experts (deepseek-moe-16b, moonshot-v1-16b-a3b):
the reference's ``repro.models.moe`` on one device.

Shared experts (always on) plus routed experts with top-k token-choice
routing and sort-based capacity dispatch: each (token, choice) pair goes
to a fixed-size (E, C, D) expert buffer, pairs past an expert's capacity C
are dropped (GShard semantics), and the expert FFN is one batched product
per weight.  Routing runs in float32.

The reference's expert-parallel path (``moe_ffn_ep``, a ``shard_map``
with all-to-alls) and the mesh branch of ``moe_ffn_auto`` wait for the
port's sharding; here :func:`moe_ffn_auto` is :func:`moe_ffn`.

The combine differs from the reference's scatter-add in form only: each
token has exactly k entries, so they are gathered back in token order
(the inverse of the dispatch sort) and summed over the k choices in
ascending expert order, a fixed order, where a scatter-add on the card
would sum them with atomics in an order that changes from run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import MoEConfig
from .layers import CastParams, empty_param, param_init
from .mlp import KINDS, mlp


class MoE(CastParams):
    """The reference's ``init_moe`` parameters: ``router`` (d, E), ``up``/
    ``gate`` (E, d, d_ff), ``down`` (E, d_ff, d) and, with shared experts,
    ``shared_up``/``shared_gate`` (d, d_ff * n_shared) and ``shared_down``."""

    def __init__(self, d_model: int, d_ff: int, cfg: MoEConfig, kind: str, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"mlp kind {kind!r} not in {KINDS}")
        self.cfg, self.kind = cfg, kind
        e = cfg.n_experts
        kw = dict(device=device, dtype=dtype)
        self.router = empty_param(d_model, e, **kw)
        self.up = empty_param(e, d_model, d_ff, **kw)
        self.down = empty_param(e, d_ff, d_model, **kw)
        gated = kind in ("swiglu", "geglu")
        if gated:
            self.gate = empty_param(e, d_model, d_ff, **kw)
        if cfg.n_shared:
            shared_ff = d_ff * cfg.n_shared
            self.shared_up = empty_param(d_model, shared_ff, **kw)
            self.shared_down = empty_param(shared_ff, d_model, **kw)
            if gated:
                self.shared_gate = empty_param(d_model, shared_ff, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal x 0.02, the router x 0.006."""
        for name, p in self.named_parameters():
            param_init(p, generator, scale=0.006 if name == "router" else 0.02)

    def forward(self, x: torch.Tensor):
        return moe_ffn(self.weights(x.dtype, keep=("router",)), x, self.cfg,
                       self.kind)


def route(router: torch.Tensor, tokens: torch.Tensor, cfg: MoEConfig):
    """float32 routing of (N, D) tokens: softmax over the experts, top-k,
    the k weights renormalised.  Returns (probs (N, E), top_w (N, k) f32,
    top_e (N, k) int64)."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True), top_e


def aux_loss(probs: torch.Tensor, top_e: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The Switch load-balancing loss: E x sum(mean prob x token share) /
    k, times the config's weight.  Tokens per expert are counted exactly
    (``bincount``), as the reference's scatter-add of ones counts them."""
    e, n = cfg.n_experts, probs.shape[0]
    counts = torch.bincount(top_e.reshape(-1), minlength=e).float()
    return cfg.router_aux_weight * e * torch.sum(probs.mean(0) * counts / n) / cfg.top_k


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert: ``max(8, ceil-ish(cf N k / E))`` as the reference."""
    return max(8, int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts + 0.999))


def dispatch(flat_e: torch.Tensor, n_experts: int, cap: int):
    """Sort-based capacity dispatch of the (N*k,) expert ids ``flat_e``.

    Returns (order, dest, keep): ``order`` a stable argsort by expert id;
    in that order, ``dest`` = expert * cap + position in the expert, or the
    overflow slot E * cap where ``keep`` (position < cap) is false."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.arange(se.numel(), device=se.device) - torch.searchsorted(
        se, se, side="left")
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, torch.full_like(se, n_experts * cap))
    return order, dest, keep


def expert_ffn(p: dict, h: torch.Tensor, kind: str) -> torch.Tensor:
    """h: (E, C, D) -> (E, C, D), one batched product per weight."""
    up = torch.bmm(h, p["up"])
    if kind == "swiglu":
        act = F.silu(torch.bmm(h, p["gate"])) * up
    elif kind == "geglu":
        act = F.gelu(torch.bmm(h, p["gate"]), approximate="tanh") * up
    else:
        act = F.gelu(up, approximate="tanh")
    return torch.bmm(act, p["down"])


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, kind: str):
    """x: (B, S, D) -> (out, aux_loss).  ``p``: the expert and shared
    weights in x's dtype, ``router`` in the parameter dtype (routing reads
    it in float32)."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    tokens = x.reshape(n, d)
    probs, top_w, top_e = route(p["router"], tokens, cfg)
    aux = aux_loss(probs, top_e, cfg)
    # each token's choices in ascending expert order: the dispatch is the
    # same (it sorts by expert) and the combine below sums in that order
    top_e, perm = top_e.sort(dim=-1)
    top_w = top_w.gather(-1, perm)

    cap = capacity(cfg, n)
    order, dest, keep = dispatch(top_e.reshape(-1), e, cap)
    st = order // k                                   # token of each sorted entry
    buf = x.new_zeros(e * cap + 1, d)
    buf[dest] = torch.where(keep[:, None], tokens[st], 0.0)   # overflow: zeros
    out_buf = expert_ffn(p, buf[:-1].view(e, cap, d), kind).reshape(e * cap, d)
    out_buf = torch.cat([out_buf, x.new_zeros(1, d)])
    contrib = out_buf[dest] * top_w.reshape(-1).to(x.dtype)[order][:, None]

    # back to (token, choice) order, then the k choices summed one by one
    by_token = torch.empty_like(contrib)
    by_token[order] = contrib
    by_token = by_token.view(n, k, d)
    routed = by_token[:, 0]
    for j in range(1, k):
        routed = routed + by_token[:, j]
    if "shared_up" in p:
        sp = {"up": p["shared_up"], "down": p["shared_down"]}
        if "shared_gate" in p:
            sp["gate"] = p["shared_gate"]
        routed = routed + mlp(sp, tokens, kind)
    return routed.reshape(b, s, d), aux


# the reference's dispatcher picks the expert-parallel path under a mesh,
# which the port does not have yet, else moe_ffn
moe_ffn_auto = moe_ffn
