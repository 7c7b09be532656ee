"""Fine-grained Mixture-of-Experts (deepseek-moe-16b, moonshot-v1-16b-a3b),
the reference's ``repro.models.moe``.

Shared experts (always on) plus routed experts with top-k token-choice
routing and sort-based capacity dispatch: each (token, choice) pair goes
to a fixed-size (E, C, D) expert buffer, pairs past an expert's capacity C
are dropped (GShard semantics), and the expert FFN is one batched product
per weight.  Routing runs in float32.

Two paths, as the reference's ``moe_ffn_auto`` picks them (here
:func:`moe_ranks`):

* :func:`moe_ffn`, every expert on this rank (one device, or a "model"
  axis of 1); where the stream is whole on every rank of M (decode), each
  rank runs its E/M experts over every token and the parts are summed
  over "model" (:func:`_routed`);
* :func:`moe_ffn_ep`, expert parallelism: each of the M ranks of the
  "model" axis holds E/M experts; a rank routes its own tokens, packs them
  by destination rank into fixed-size send buffers, and an all-to-all
  carries them to their experts and another one brings the outputs back.
  The exchange goes through a comm object (``repro_torch.dist.comm``):
  ``LocalComm`` holds every rank in one process, ``DistComm`` runs over a
  process group.

The combine differs from the reference's scatter-add in form only: each
token has exactly k entries, so they are gathered back in token order and
summed over the k choices in ascending expert order, a fixed order, where
a scatter-add on the card would sum them with atomics in an order that
changes from run to run (a checkpointed layer's recompute must give its
first pass's values).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.comm import SOLO
from .config import MoEConfig
from .layers import CastParams, empty_param, param_init
from .mlp import KINDS, mlp, mlp_ranks


class Experts(CastParams):
    """The routed experts' weights, ``up``/``gate`` (n, d, d_ff) and
    ``down`` (n, d_ff, d), for experts ``lo .. lo + n - 1`` of
    ``n_experts`` (all of them by default).  Called on (n, C, d) expert
    buffers, it applies each expert's FFN to its rows: the weights are
    read inside the call, so a parameter-sharding wrapper (FSDP) gathers
    them around it."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, kind: str, *,
                 lo: int = 0, n: int | None = None, device=None, dtype=torch.float32):
        super().__init__()
        n = n_experts if n is None else n
        self.kind, self.n_experts, self.lo = kind, n_experts, lo
        kw = dict(device=device, dtype=dtype)
        self.up = empty_param(n, d_model, d_ff, **kw)
        self.down = empty_param(n, d_ff, d_model, **kw)
        if kind in ("swiglu", "geglu"):
            self.gate = empty_param(n, d_model, d_ff, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal x 0.02, each weight drawn for all ``n_experts`` and this
        module's rows kept: a model that holds some of the experts holds
        the values of one that holds them all."""
        for p in self.parameters():
            if p.shape[0] == self.n_experts:
                param_init(p, generator)
                continue
            full = torch.empty((self.n_experts,) + tuple(p.shape[1:]),
                               device=p.device, dtype=p.dtype)
            param_init(full, generator)
            p.copy_(full[self.lo:self.lo + p.shape[0]])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return expert_ffn(self.weights(h.dtype), h, self.kind)


class MoE(CastParams):
    """The reference's ``init_moe`` parameters: ``router`` (d, E), the
    routed experts (:class:`Experts`) and, with shared experts,
    ``shared_up``/``shared_gate`` (d, d_ff * n_shared) and ``shared_down``.

    ``comm`` (None: one rank) is the comm of a model built across ranks
    (``repro_torch.dist.zero``), over which the aux loss is taken;
    ``experts`` then holds the rank's E/M experts where expert parallelism
    applies."""

    def __init__(self, d_model: int, d_ff: int, cfg: MoEConfig, kind: str, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"mlp kind {kind!r} not in {KINDS}")
        self.cfg, self.kind, self.comm = cfg, kind, None
        kw = dict(device=device, dtype=dtype)
        self.router = empty_param(d_model, cfg.n_experts, **kw)
        self.experts = Experts(d_model, d_ff, cfg.n_experts, kind, **kw)
        if cfg.n_shared:
            shared_ff = d_ff * cfg.n_shared
            self.shared_up = empty_param(d_model, shared_ff, **kw)
            self.shared_down = empty_param(shared_ff, d_model, **kw)
            if kind in ("swiglu", "geglu"):
                self.shared_gate = empty_param(d_model, shared_ff, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal x 0.02, the router x 0.006; drawn in the order router,
        experts, shared experts."""
        param_init(self.router, generator, scale=0.006)
        self.experts.reset_parameters(generator)
        for p in self._parameters.values():
            if p is not self.router:
                param_init(p, generator)

    def forward(self, x: torch.Tensor, rank=SOLO, sp: bool = False):
        """This rank's MoE FFN over its stream (:func:`moe_ranks`): (out,
        aux)."""
        outs, auxs = moe_ranks([self], [x], [rank], sp)
        return outs[0], auxs[0]


def route(router: torch.Tensor, tokens: torch.Tensor, cfg: MoEConfig):
    """float32 routing of (N, D) tokens: softmax over the experts, top-k,
    the k weights renormalised.  Returns (probs (N, E), top_w (N, k) f32,
    top_e (N, k) int64)."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True), top_e


def _counts(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Tokens per expert, counted exactly (``bincount``), as the
    reference's scatter-add of ones counts them."""
    return torch.bincount(top_e.reshape(-1), minlength=n_experts).float()


def aux_loss(probs: torch.Tensor, top_e: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The Switch load-balancing loss: E x sum(mean prob x token share) /
    k, times the config's weight."""
    e, n = cfg.n_experts, probs.shape[0]
    counts = _counts(top_e, e)
    return cfg.router_aux_weight * e * torch.sum(probs.mean(0) * counts / n) / cfg.top_k


def mean_aux_loss(probs_and_top_e: list, cfg: MoEConfig, comm) -> list:
    """The aux loss over every rank's tokens: each rank's mean prob and
    token share are averaged over all ranks (``comm.all_mean``, the
    reference's ``pmean`` over every mesh axis) before the product."""
    mes = comm.all_mean([probs.mean(0) for probs, _ in probs_and_top_e])
    ces = comm.all_mean([_counts(top_e, cfg.n_experts) / top_e.shape[0]
                         for _, top_e in probs_and_top_e])
    return [cfg.router_aux_weight * cfg.n_experts * torch.sum(me * ce) / cfg.top_k
            for me, ce in zip(mes, ces)]


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


def pack_by(dest: torch.Tensor, values: torch.Tensor, n_bins: int, cap: int):
    """Sort-based fixed-capacity packing (the reference's ``_pack_by``).

    dest: (M,) bin ids; values: (M, ...).  Returns (buf (n_bins, cap, ...),
    slot (M,) int64 = bin * cap + position, or -1 where the entry was
    dropped).  Within a bin entries keep their order; zeros fill the rest."""
    order, slot_sorted, keep = dispatch(dest, n_bins, cap)
    buf = values.new_zeros((n_bins * cap + 1,) + tuple(values.shape[1:]))
    kept = keep.reshape((-1,) + (1,) * (values.dim() - 1))
    buf[slot_sorted] = torch.where(kept, values[order], 0.0)   # overflow: zeros
    slot = torch.empty_like(dest)
    slot[order] = torch.where(keep, slot_sorted, -1)
    return buf[:-1].reshape((n_bins, cap) + tuple(values.shape[1:])), slot


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


def _combine(contrib: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """(N*k, D) contributions in (token, choice) order -> (N, D): each
    token's k choices summed one by one in ascending expert order."""
    n, k = top_e.shape
    perm = top_e.argsort(dim=-1)
    by_token = contrib.view(n, k, -1)[torch.arange(n, device=perm.device)[:, None], perm]
    routed = by_token[:, 0]
    for j in range(1, k):
        routed = routed + by_token[:, j]
    return routed


def _shared(p: dict, tokens: torch.Tensor, kind: str) -> torch.Tensor | None:
    if "shared_up" not in p:
        return None
    sp = {"up": p["shared_up"], "down": p["shared_down"]}
    if "shared_gate" in p:
        sp["gate"] = p["shared_gate"]
    return mlp(sp, tokens, kind)


def _routed(p: dict, x: torch.Tensor, cfg: MoEConfig, kind: str, ffn=None, m: int = 0,
            M: int = 1):
    """The routed experts over x: (B, S, D), all of its tokens routed and
    the experts ``m E/M .. (m+1) E/M - 1`` run on the pairs they keep
    (all of them at M = 1; ``p``/``ffn`` hold those experts).  Returns
    (their part of the output (N, D), probs, top_e): the sum of the M
    parts is the routed output."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    tokens = x.reshape(n, d)
    probs, top_w, top_e = route(p["router"], tokens, cfg)
    cap = capacity(cfg, n)
    # the dispatch sorts by expert, so the choices' order within a token
    # does not matter to it; in ascending order, the combine sums them so
    top_e_s, perm = top_e.sort(dim=-1)
    top_w = top_w.gather(-1, perm)
    order, dest, keep = dispatch(top_e_s.reshape(-1), e, cap)
    e_loc = e // M
    first = m * e_loc * cap
    mine = keep & (dest >= first) & (dest < first + e_loc * cap)
    ldest = torch.where(mine, dest - first, torch.full_like(dest, e_loc * cap))
    buf = x.new_zeros(e_loc * cap + 1, d)
    buf[ldest] = torch.where(mine[:, None], tokens[order // k], 0.0)   # others: zeros
    hidden = buf[:-1].view(e_loc, cap, d)
    out_buf = ffn(hidden) if ffn is not None else expert_ffn(p, hidden, kind)
    out_buf = torch.cat([out_buf.reshape(e_loc * cap, d), x.new_zeros(1, d)])
    contrib = x.new_empty(n * k, d)
    contrib[order] = out_buf[ldest] * top_w.reshape(-1).to(x.dtype)[order][:, None]
    return _combine(contrib, top_e_s), probs, top_e


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, kind: str, *, ffn=None,
            comm=None):
    """x: (B, S, D) -> (out, aux_loss).  ``p``: the router in the
    parameter dtype (routing reads it in float32), the shared experts in
    x's dtype and, unless ``ffn`` maps (E, C, D) buffers through the
    experts (an :class:`Experts`), ``up``/``gate``/``down`` in x's dtype.
    With a ``comm`` (a rank of a model across ranks, every expert on it)
    the aux loss is taken over every rank's tokens."""
    b, s, d = x.shape
    routed, probs, top_e = _routed(p, x, cfg, kind, ffn)
    aux = (aux_loss(probs, top_e, cfg) if comm is None
           else mean_aux_loss([(probs, top_e)], cfg, comm)[0])
    shared = _shared(p, x.reshape(b * s, d), kind)
    if shared is not None:
        routed = routed + shared
    return routed.reshape(b, s, d), aux


def moe_ffn_ep(ps: list, xs: list, cfg: MoEConfig, kind: str, comm, *, ffns=None,
               stats: dict | None = None):
    """Expert parallelism over the M ranks of ``comm``'s "model" axis (the
    reference's ``moe_ffn_ep`` body, per rank).  Lists hold one entry per
    rank that ``comm`` runs in this process, in its rank order: ``xs`` the
    rank's tokens (B, S, D), all of one shape; ``ps`` its weights as
    :func:`moe_ffn` takes them, with its E/M experts ``m E/M ..``; ``ffns``
    (optional) its :class:`Experts`.  Returns (outputs, aux losses).

    Per rank: route the n local tokens; pack each (token, choice) pair,
    with its expert's local id and a validity flag as two more columns in
    x's dtype (exact in bfloat16 below 256), into (M, C_send, D + 2) by
    destination rank; all-to-all; pack the received rows by local expert
    into (E/M, C_loc, D) (padding rows into an overflow bin, sliced off);
    the experts; back to receive order; the reverse all-to-all; combine.
    C_send = max(8, int(cf n k / M + 0.999)) and C_loc = max(8, int(cf M
    C_send / (E/M) + 0.999)), as the reference's.  The aux loss averages
    each rank's mean prob and token share over every rank.

    ``stats`` (a dict), if given, receives the pairs routed and those
    dropped at the send buffers and at the experts, over this process's
    ranks (read on the host: it waits for the device)."""
    e, k, tp = cfg.n_experts, cfg.top_k, comm.model
    e_loc = e // tp
    if e % tp or len(ps) != len(xs) or len({tuple(x.shape) for x in xs}) != 1:
        raise ValueError(f"moe_ffn_ep: {e} experts over {tp} ranks, "
                         f"{len(ps)} weight sets, inputs {[tuple(x.shape) for x in xs]}")
    b, s, d = xs[0].shape
    n = b * s
    c_send = max(8, int(cfg.capacity_factor * n * k / tp + 0.999))
    c_loc = max(8, int(cfg.capacity_factor * tp * c_send / e_loc + 0.999))
    routes = [route(p["router"], x.reshape(n, d), cfg) for p, x in zip(ps, xs)]
    auxs = mean_aux_loss([(probs, top_e) for probs, _, top_e in routes], cfg, comm)
    sends, slots = [], []
    for x, (_, _, top_e) in zip(xs, routes):
        flat_e = top_e.reshape(-1)
        payload = torch.cat([x.reshape(n, d).repeat_interleave(k, dim=0),
                             (flat_e % e_loc).to(x.dtype)[:, None],
                             x.new_ones(n * k, 1)], dim=1)
        send, slot = pack_by(flat_e // e_loc, payload, tp, c_send)
        sends.append(send)
        slots.append(slot)
    backs, hslots = [], []
    for i, recv in enumerate(comm.all_to_all(sends)):
        rows = recv.reshape(tp * c_send, d + 2)
        valid = rows[:, d + 1] > 0.5
        rexp = torch.where(valid, rows[:, d].long().clamp(0, e_loc - 1), e_loc)
        hidden, hslot = pack_by(rexp, rows[:, :d], e_loc + 1, c_loc)
        hidden = hidden[:e_loc]
        h_out = (ffns[i](hidden) if ffns is not None
                 else expert_ffn(ps[i], hidden, kind))
        flat_out = torch.cat([h_out.reshape(e_loc * c_loc, d), h_out.new_zeros(1, d)])
        hs = torch.where((hslot >= 0) & (hslot < e_loc * c_loc), hslot, e_loc * c_loc)
        backs.append(flat_out[hs].reshape(tp, c_send, d))
        hslots.append((valid, hslot))
    outs = []
    for x, p, ret, slot, (_, top_w, top_e) in zip(xs, ps, comm.all_to_all(backs),
                                                  slots, routes):
        ret_flat = torch.cat([ret.reshape(tp * c_send, d), ret.new_zeros(1, d)])
        contrib = (ret_flat[torch.where(slot >= 0, slot, tp * c_send)]
                   * top_w.reshape(-1, 1).to(x.dtype))
        routed = _combine(contrib, top_e)
        shared = _shared(p, x.reshape(n, d), kind)
        if shared is not None:
            routed = routed + shared
        outs.append(routed.reshape(b, s, d))
    if stats is not None:
        stats["pairs"] = len(xs) * n * k
        stats["dropped_send"] = sum(int((slot < 0).sum()) for slot in slots)
        stats["dropped_local"] = sum(int((valid & (hslot < 0)).sum())
                                     for valid, hslot in hslots)
    return outs, auxs


def moe_ranks(moes: list, hs: list, ranks: list, sp: bool):
    """The MoE FFN of each rank of a data row (``moes``: its :class:`MoE`,
    ``hs``: its stream, its sequence shard with ``sp``; ``ranks``: its
    ``repro_torch.dist.comm.Rank``).  Returns (outputs, aux losses).

    The routed experts run by expert parallelism on the rank's sequence
    shard (:func:`moe_ffn_ep`, the reference's ``(dp, sp)`` layout) where
    the sequence splits over M > 1 ranks; else (one rank, or the stream
    whole on every rank, as in decode) each rank routes every token, runs
    its own experts and the parts are summed over "model" in one
    all-reduce with the shared experts' parts.  The shared experts are
    tensor-parallel over ff (their activation rule, ``mlp.py:32``): the
    stored leaves are whole (no TP rule names them) and each rank reads its
    ff columns.  The aux loss is taken over the ranks of ``moe.comm``
    (None: this rank's tokens)."""
    moe0, r0 = moes[0], ranks[0]
    cfg, kind, comm, M = moe0.cfg, moe0.kind, r0.comm, r0.M
    ps = [m.weights(h.dtype, keep=("router",)) for m, h in zip(moes, hs)]
    routed = [{k: v for k, v in p.items() if not k.startswith("shared_")} for p in ps]
    shared, split = [], False
    if "shared_up" in ps[0]:
        ff = ps[0]["shared_up"].shape[1]
        split = M > 1 and ff % M == 0
        for p, r in zip(ps, ranks):
            cols = slice(r.m * ff // M, (r.m + 1) * ff // M) if split else slice(None)
            w = {"up": p["shared_up"][:, cols], "down": p["shared_down"][cols]}
            if "shared_gate" in p:
                w["gate"] = p["shared_gate"][:, cols]
            shared.append(w)
    if sp and M > 1:
        outs, auxs = moe_ffn_ep(routed, hs, cfg, kind, comm,
                                ffns=[m.experts for m in moes])
        if shared:
            outs = [o + t for o, t in zip(outs, mlp_ranks(shared, hs, kind, ranks, sp,
                                                          split))]
        return outs, auxs
    parts, routes = [], []
    for i, (moe, p, h, r) in enumerate(zip(moes, routed, hs, ranks)):
        part, probs, top_e = _routed(p, h, cfg, kind, moe.experts, r.m, M)
        routes.append((probs, top_e))
        if split:                  # the shared experts' part joins the one sum
            part = part + mlp(shared[i], h.reshape(part.shape), kind)
        parts.append(part.reshape(h.shape))
    outs = comm.sum(parts)
    if shared and not split:
        outs = [o + mlp(w, h, kind) for o, w, h in zip(outs, shared, hs)]
    auxs = (mean_aux_loss(routes, cfg, moe0.comm) if moe0.comm is not None
            else [aux_loss(probs, top_e, cfg) for probs, top_e in routes])
    return outs, auxs
