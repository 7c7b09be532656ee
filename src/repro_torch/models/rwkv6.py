"""RWKV-6 "Finch" block (rwkv6-3b): attention-free time mix with a
data-dependent decay per channel.  The reference's ``repro.models.rwkv6``.

Recurrence per head (K = V = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: K x V, float32)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(w0 + tanh(x_t' A_w) B_w)).  A sequence longer than
:data:`WKV_CHUNK` whose length it divides runs the reference's chunked
form (:func:`wkv6_chunked`, formula for formula, exponents clipped at
+-:data:`EXP_CLIP`); other lengths and decode run the exact step scan.

Dtypes follow the reference's promotions: a token-shift carry wider than
the input (a float32 cache under bfloat16 compute) widens the mixes, and
with them the projections (weights rounded to the compute dtype, then
widened) and the block's output, so the residual stream leaves the block
in the wider type, as JAX's type promotion has it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.comm import SOLO, cut_seq, gather_seq, reduce_seq
from .layers import CastParams, empty_param, param_init, rms_norm

LORA_R = 64          # rank of the data-dependent decay's low-rank map
WKV_CHUNK = 32       # chunk length of the chunked WKV form
EXP_CLIP = 60.0      # |exponent| clip of its intra-chunk factorisation

# read in float32 from the parameter dtype, as the reference does
TMIX_RAW = ("w0", "wa", "wb", "u", "ln_scale")


class TimeMix(CastParams):
    """``wr``/``wk``/``wv``/``wg``/``wo`` (d, d), ``mix`` (5, d), the decay's
    ``w0`` (d,), ``wa`` (d, 64), ``wb`` (64, d), the bonus ``u`` (d,) and the
    per-head group norm's ``ln_scale`` (H, head_dim)."""

    def __init__(self, d_model: int, head_dim: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.head_dim = head_dim
        kw = dict(device=device, dtype=dtype)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, empty_param(d_model, d_model, **kw))
        self.mix = empty_param(5, d_model, **kw)
        self.w0 = empty_param(d_model, **kw)
        self.wa = empty_param(d_model, LORA_R, **kw)
        self.wb = empty_param(LORA_R, d_model, **kw)
        self.u = empty_param(d_model, **kw)
        self.ln_scale = empty_param(d_model // head_dim, head_dim, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("wr", "wk", "wv", "wg", "wo", "wa"):
            param_init(getattr(self, name), generator)
        param_init(self.wb, generator, scale=0.002)
        param_init(self.u, generator, scale=0.5)
        self.mix.fill_(0.5)
        self.w0.fill_(-2.0)
        self.ln_scale.fill_(1.0)


class ChannelMix(CastParams):
    """``wr`` (d, d), ``wk`` (d, d_ff), ``wv`` (d_ff, d), ``mix`` (2, d)."""

    def __init__(self, d_model: int, d_ff: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wr = empty_param(d_model, d_model, **kw)
        self.wk = empty_param(d_model, d_ff, **kw)
        self.wv = empty_param(d_ff, d_model, **kw)
        self.mix = empty_param(2, d_model, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("wr", "wk", "wv"):
            param_init(getattr(self, name), generator)
        self.mix.fill_(0.5)


def _shifted(x: torch.Tensor, x_prev):
    """(x, its token shift [x_prev, x_0 .. x_{S-2}]) in their promoted
    dtype; x_prev (B, D) is the previous segment's last input (zeros when
    None)."""
    if x_prev is None:
        x_prev = x.new_zeros(x.shape[0], x.shape[2])
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)     # in the promoted dtype
    return x.to(xs.dtype), xs


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with w (in the compute dtype) widened to a's dtype, as JAX
    promotes a mixed product."""
    return a @ w.to(a.dtype)


def decay(p: dict, xm: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay w_t in (0, 1), float32: (B, S, D)."""
    lr = torch.tanh(xm.float() @ p["wa"].float())
    return torch.exp(-torch.exp(p["w0"].float() + lr @ p["wb"].float()))


def wkv6_chunked(r, k, v, w, u, state, chunk: int = WKV_CHUNK):
    """Chunked WKV6 (the reference's ``_wkv6_chunked``): the state is read
    and written once per chunk.

    r/k/v: (B, S, H, K) float32; w: (B, S, H, K) decay in (0, 1); u: (H,
    K); state: (B, H, K, V).  Returns (o (B, S, H, V), final state).  The
    inter-chunk terms use exponents <= 0 (exact); the intra-chunk
    attention factorises exp(cum_{t-1} - cum_s) as exp(cum_{t-1})
    exp(-cum_s), each exponent clipped at +-EXP_CLIP, which is exact while
    a chunk's total decay exponent stays below it."""
    b, s, h, kd = r.shape
    g = s // chunk
    rr, kk, vv, ww = (t.reshape(b, g, chunk, h, t.shape[-1]) for t in (r, k, v, w))
    logw = torch.log(torch.clamp(ww, min=1e-38))          # (B,G,C,H,K) <= 0
    cum = torch.cumsum(logw, dim=2)
    cum_prev = cum - logw                                 # cum_{t-1}, 0 at t = 0
    cum_last = cum[:, :, -1]                              # (B,G,H,K)

    # inter-chunk states
    decay_k = torch.exp(cum_last[:, :, None] - cum)       # <= 1
    sg = torch.einsum("bgchk,bgchv->bghkv", decay_k * kk, vv)
    prev = []
    for i in range(g):
        prev.append(state)
        state = state * torch.exp(cum_last[:, i])[..., None] + sg[:, i]
    s_prev = torch.stack(prev, dim=1)                     # (B,G,H,K,V)

    # inter-chunk output
    o_inter = torch.einsum("bgchk,bghkv->bgchv", rr * torch.exp(cum_prev), s_prev)

    # intra-chunk attention (factored; clipped exponents)
    r2 = rr * torch.exp(torch.clamp(cum_prev, -EXP_CLIP, EXP_CLIP))
    k2 = kk * torch.exp(torch.clamp(-cum, -EXP_CLIP, EXP_CLIP))
    a = torch.einsum("bgchk,bgshk->bghcs", r2, k2)        # (B,G,H,C,C)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=r.device).tril(-1)
    a = torch.where(tri, a, 0.0)
    diag = torch.einsum("bgchk,hk,bgchk->bgch", rr, u, kk)
    o_intra = torch.einsum("bghcs,bgshv->bgchv", a, vv) + diag[..., None] * vv
    return (o_inter + o_intra).reshape(b, s, h, v.shape[-1]), state


def wkv6_steps(r, k, v, w, u, state):
    """The exact scan, one step per token; inputs as
    :func:`wkv6_chunked`'s.  Returns (o (B, S, H, V), final state)."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]               # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def _mode(p: dict, d: int, head_dim: int, r) -> str:
    """How rank ``r`` holds the time mix (``p``: its weights): ``"heads"``
    (its H/M heads: ``wk``/``wv`` split on whole heads' columns; all of
    them at M = 1), ``"cols"`` (a column slice of ``wk``/``wv`` that cuts
    a head: the projections are gathered over "model" and every head
    computed) or ``"whole"`` (the leaves unsplit)."""
    if r.M == 1:
        return "heads"
    if p["wk"].shape[1] == d:
        return "whole"
    return "heads" if (d // head_dim) % r.M == 0 else "cols"


def time_mix_ranks(ps: list, xs: list, head_dim: int, states: list, x_prevs: list,
                   ranks: list, sp: bool = False):
    """RWKV6 time mix of each rank of a data row (``ps``: its weights, as
    :func:`time_mix` takes them; ``wk``/``wv`` its column shard and ``wo``
    its row shard under the rules, the other leaves whole).  ``xs``: the
    normed streams (sequence shards with ``sp``: gathered first, so that
    the token shift sees its neighbour); ``states``: each rank's WKV state
    (its heads, or all of them where they do not split) or None;
    ``x_prevs``: the whole shift carries or None.  A rank computes its own
    heads (every head where a head is cut) on the whole sequence: r, g and
    the decay read the heads' columns of their whole leaves, the WKV scan
    and the per-head group norm run on those heads, and ``wo``'s partial
    products are reduced over "model" (reduce-scattered onto the sequence
    shards with ``sp``).  Returns (outs, [(state, x_last)])."""
    comm = ranks[0].comm
    xs = gather_seq(comm, xs, sp)
    b, s, d = xs[0].shape
    mode = _mode(ps[0], d, head_dim, ranks[0])
    mixed, ks, vs = [], [], []
    for p, x, x_prev in zip(ps, xs, x_prevs):
        xw_, xsh = _shifted(x, x_prev)
        mix = p["mix"]
        mixed.append([xw_ + mix[i] * (xsh - xw_) for i in range(5)])
        ks.append(_mm(mixed[-1][1], p["wk"]))
        vs.append(_mm(mixed[-1][2], p["wv"]))
    if mode == "cols":
        ks, vs = comm.gather(ks, -1), comm.gather(vs, -1)
    f32 = torch.float32
    outs, carries = [], []
    for p, x, (xr, _, _, xg, xw), k, v, state, r in zip(ps, xs, mixed, ks, vs, states,
                                                        ranks):
        own = d // r.M
        cols = slice(r.m * own, (r.m + 1) * own) if mode == "heads" else slice(None)
        h = k.shape[-1] // head_dim
        dt = x.dtype
        rr = _mm(xr, p["wr"][:, cols]).reshape(b, s, h, head_dim).to(f32)
        k = k.reshape(b, s, h, head_dim).to(f32)
        v = v.reshape(b, s, h, head_dim).to(f32)
        g = F.silu(_mm(xg, p["wg"][:, cols]))
        w = decay({"wa": p["wa"], "w0": p["w0"][cols], "wb": p["wb"][:, cols]},
                  xw).reshape(b, s, h, head_dim)
        u = p["u"][cols].float().reshape(h, head_dim)
        if state is None:
            state = torch.zeros(b, h, head_dim, head_dim, device=x.device)
        if s > WKV_CHUNK and s % WKV_CHUNK == 0:
            o, state = wkv6_chunked(rr, k, v, w, u, state)
        else:
            o, state = wkv6_steps(rr, k, v, w, u, state)

        # per-head group norm
        mean = o.mean(-1, keepdim=True)
        var = o.var(-1, unbiased=False, keepdim=True)
        scale = p["ln_scale"][r.m * h:(r.m + 1) * h] if mode == "heads" else p["ln_scale"]
        o = (o - mean) * torch.rsqrt(var + 1e-5) * scale
        o = o.reshape(b, s, h * head_dim).to(dt) * g
        if mode == "cols":                     # wo's rows: this rank's columns of o
            o = o[..., r.m * own:(r.m + 1) * own]
        outs.append(_mm(o, p["wo"]))
        carries.append((state, x[:, -1]))
    if mode == "whole":
        return cut_seq(outs, ranks, sp), carries
    return reduce_seq(comm, outs, sp), carries


def time_mix(p: dict, x: torch.Tensor, head_dim: int, state=None, x_prev=None):
    """RWKV6 time mix.  x: (B, S, D).  Returns (out, (state, x_last)).

    ``p``: ``wr``/``wk``/``wv``/``wg``/``wo``/``mix`` in x's dtype, the
    rest (:data:`TMIX_RAW`) in the parameter dtype.  ``state``: the (B, H,
    K, V) float32 WKV state carried in (zeros when None); ``x_prev``: the
    token-shift carry (B, D)."""
    (out,), (carry,) = time_mix_ranks([p], [x], head_dim, [state], [x_prev], [SOLO])
    return out, carry


def channel_mix_ranks(ps: list, xs: list, x_prevs: list, ranks: list, sp: bool = False):
    """RWKV6 channel mix of each rank (``ps``: its weights in x's dtype;
    ``wk`` split on its ff columns and ``wv`` (d_ff, d) on its output
    columns under the rules, ``wr`` whole).  Over the gathered sequence a
    rank takes relu(xk wk)^2 on its ff slice, gathers it over "model" (the
    reference's ``kk: ("batch", None, "ff")``), multiplies by its output
    columns of ``wv`` and gates them by sigmoid(xr wr) on the same columns;
    the columns are then gathered and each rank keeps its sequence shard
    with ``sp``.  Returns (outs, x_lasts)."""
    comm = ranks[0].comm
    xs = gather_seq(comm, xs, sp)
    d = xs[0].shape[-1]
    split_ff = ps[0]["wk"].shape[1] != ps[0]["wv"].shape[0]
    split_out = ps[0]["wv"].shape[1] != d
    kks, xrs = [], []
    for p, x, x_prev in zip(ps, xs, x_prevs):
        xw_, xsh = _shifted(x, x_prev)
        mix = p["mix"]
        xk = xw_ + mix[0] * (xsh - xw_)
        xrs.append(xw_ + mix[1] * (xsh - xw_))
        kks.append(torch.square(torch.relu(_mm(xk, p["wk"]))))
    if split_ff:
        kks = comm.gather(kks, -1)
    outs = []
    for p, xr, kk, r in zip(ps, xrs, kks, ranks):
        own = p["wv"].shape[1]
        wr = p["wr"][:, r.m * own:(r.m + 1) * own] if split_out else p["wr"]
        outs.append(torch.sigmoid(_mm(xr, wr)) * _mm(kk, p["wv"]))
    if split_out:
        outs = comm.gather(outs, -1)
    return cut_seq(outs, ranks, sp), [x[:, -1] for x in xs]


def channel_mix(p: dict, x: torch.Tensor, x_prev=None):
    """RWKV6 channel mix; ``p`` in x's dtype.  Returns (out, x_last)."""
    (out,), (last,) = channel_mix_ranks([p], [x], [x_prev], [SOLO])
    return out, last


def rwkv_ranks(layers: list, xs: list, states: list, sp: bool = False):
    """One rwkv6 layer of each rank of a data row (its stream: its
    sequence shard with ``sp``; ``states``: each rank's ``{"wkv",
    "tshift1", "tshift2"}`` or None).  Returns (streams, new states)."""
    l0 = layers[0]
    ranks = [lay.tp for lay in layers]
    sts = [st or {} for st in states]
    hs = [rms_norm(x, lay.norm1, l0.norm_eps) for lay, x in zip(layers, xs)]
    tmix = l0.block["tmix"]
    atts, carries = time_mix_ranks(
        [lay.block["tmix"].weights(h.dtype, keep=TMIX_RAW) for lay, h in zip(layers, hs)],
        hs, tmix.head_dim, [st.get("wkv") for st in sts], [st.get("tshift1") for st in sts],
        ranks, sp)
    xs = [x + a for x, a in zip(xs, atts)]
    hs = [rms_norm(x, lay.norm2, l0.norm_eps) for lay, x in zip(layers, xs)]
    ffs, lasts = channel_mix_ranks([lay.block["cmix"].weights(h.dtype) for lay, h in
                                    zip(layers, hs)], hs, [st.get("tshift2") for st in sts],
                                   ranks, sp)
    return ([x + f for x, f in zip(xs, ffs)],
            [{"wkv": wkv, "tshift1": xl1, "tshift2": xl2}
             for (wkv, xl1), xl2 in zip(carries, lasts)])


class RWKVLayer(nn.Module):
    """One layer of the reference's rwkv6 stack: ``block`` (``tmix``,
    ``cmix``) and its two pre-norms ``norm1``/``norm2``."""

    def __init__(self, d_model: int, d_ff: int, head_dim: int, norm_eps: float, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.norm_eps, self.tp = norm_eps, SOLO
        self.block = nn.ModuleDict({
            "tmix": TimeMix(d_model, head_dim, device=device, dtype=dtype),
            "cmix": ChannelMix(d_model, d_ff, device=device, dtype=dtype)})
        self.norm1 = empty_param(d_model, device=device, dtype=dtype)
        self.norm2 = empty_param(d_model, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.block["tmix"].reset_parameters(generator)
        self.block["cmix"].reset_parameters(generator)
        self.norm1.fill_(1.0)
        self.norm2.fill_(1.0)

    def forward(self, x, state=None, sp: bool = False):
        """x: (B, S, D) (this rank's sequence shard with ``sp``); ``state``:
        None (a fresh sequence) or ``{"wkv", "tshift1", "tshift2"}``.
        Returns (x, new state)."""
        (x,), (st,) = rwkv_ranks([self], [x], [state], sp)
        return x, st
