"""Mamba2 (SSD) block, the zamba2-2.7b backbone: the reference's
``repro.models.mamba2``.

State-space recurrence with a SCALAR decay per head and step:

    h_t = a_t h_{t-1} + dt_t (B_t x_t^T)        h: (N, P) per head
    y_t = C_t^T h_t + D x_t

with a_t = exp(-softplus(dt_raw + dt_bias) exp(a_log)).  A prompt whose
length is a multiple of the chunk (and longer than one token) runs the
reference's chunked form (:func:`ssd_chunked`, formula for formula); other
lengths and every decode step run the exact step scan.  Both keep the
state in float32.  Dtypes follow the reference's promotions: a float32
conv state from the cache makes the depthwise conv float32 too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.comm import SOLO, cut_seq, gather_seq
from .config import SSMConfig
from .layers import CastParams, empty_param, param_init

# read in float32 from the parameter dtype, as the reference does
RAW = ("a_log", "dt_bias", "d_skip")


class Mamba2(CastParams):
    """The reference's ``init_mamba2`` parameters: ``in_proj`` (d, 2
    d_inner + 2 N + nh) packing [z, x, B, C, dt], ``conv_w`` (K, d_inner +
    2 N), ``conv_b``, ``a_log``/``dt_bias``/``d_skip`` (nh,), ``out_proj``
    (d_inner, d), ``norm_scale`` (d_inner,)."""

    def __init__(self, d_model: int, cfg: SSMConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.d_model = cfg, d_model
        d_inner = cfg.expand * d_model
        nh = d_inner // cfg.head_dim
        conv_c = d_inner + 2 * cfg.d_state
        kw = dict(device=device, dtype=dtype)
        self.in_proj = empty_param(d_model, 2 * d_inner + 2 * cfg.d_state + nh, **kw)
        self.conv_w = empty_param(cfg.d_conv, conv_c, **kw)
        self.conv_b = empty_param(conv_c, **kw)
        self.a_log = empty_param(nh, **kw)
        self.dt_bias = empty_param(nh, **kw)
        self.d_skip = empty_param(nh, **kw)
        self.out_proj = empty_param(d_inner, d_model, **kw)
        self.norm_scale = empty_param(d_inner, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Projections normal x 0.02, the conv x 0.2; conv bias and dt
        bias 0, skip and norm 1, a_log = log(linspace(1, 16, nh))."""
        param_init(self.in_proj, generator)
        param_init(self.conv_w, generator, scale=0.2)
        param_init(self.out_proj, generator)
        self.conv_b.zero_()
        self.dt_bias.zero_()
        self.d_skip.fill_(1.0)
        self.norm_scale.fill_(1.0)
        nh = self.a_log.shape[0]
        self.a_log.copy_(torch.as_tensor(
            np.log(np.linspace(1.0, 16.0, nh, dtype=np.float32))))


def causal_conv(p: dict, u: torch.Tensor, state=None):
    """Depthwise causal conv1d over time, then SiLU.  u: (B, S, C); state:
    the previous (B, K-1, C) inputs (zeros when None).  Returns (out, the
    last K-1 inputs), both in the promoted dtype of u and the state."""
    w = p["conv_w"].to(u.dtype)
    k = w.shape[0]
    pad = (u.new_zeros(u.shape[0], k - 1, u.shape[2]) if state is None else state)
    ext = torch.cat([pad, u], dim=1)            # in the promoted dtype
    s = u.shape[1]
    out = ext[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + s] * w[i]
    new_state = ext[:, -(k - 1):] if k > 1 else None
    return F.silu(out + p["conv_b"].to(u.dtype)), new_state


def ssd_chunked(xh, bt, ct, a, dt, chunk: int):
    """Chunked SSD scan (the reference's ``_ssd_chunked``).

    xh: (B, S, H, P); bt/ct: (B, S, N); a: (B, S, H) decay in (0, 1); dt:
    (B, S, H) step sizes (float32).  Returns (y (B, S, H, P) float32, the
    final state (B, H, N, P) float32)."""
    b, s, h, pdim = xh.shape
    n = bt.shape[-1]
    g = s // chunk
    f32 = torch.float32
    xr = xh.reshape(b, g, chunk, h, pdim).to(f32)
    br = bt.reshape(b, g, chunk, n)
    cr = ct.reshape(b, g, chunk, n)
    lar = torch.log(a).reshape(b, g, chunk, h)
    dtr = dt.reshape(b, g, chunk, h)

    cum = torch.cumsum(lar, dim=2)                              # (B,G,C,H)
    total = cum[:, :, -1]                                       # (B,G,H)
    # intra-chunk: score[t, s'] = C_t . B_s' exp(cum_t - cum_s') dt_s'
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,G,C,C,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device).tril()
    # masked before exp: above the diagonal rel > 0 can overflow exp to inf,
    # and the backward's 0 x inf would be NaN (ROADMAP F8)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], rel, -torch.inf))
    cb = torch.einsum("bgtn,bgsn->bgts", cr, br).to(f32)        # in B/C's dtype
    w = cb[..., None] * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bgtsh,bgshp->bgthp", w, xr)

    # chunk states: S_g = sum_s exp(total - cum_s) dt_s B_s x_s
    wstate = torch.exp(total[:, :, None] - cum) * dtr           # (B,G,C,H)
    sg = torch.einsum("bgsh,bgsn,bgshp->bghnp", wstate, br.to(f32), xr)

    # inter-chunk scan over G (sequential, small): the state before each
    dec_tot = torch.exp(total)                                  # (B,G,H)
    state = xr.new_zeros(b, h, n, pdim)
    prev = []
    for i in range(g):
        prev.append(state)
        state = state * dec_tot[:, i, :, None, None] + sg[:, i]
    s_prev = torch.stack(prev, dim=1)                           # (B,G,H,N,P)

    y_inter = torch.einsum("bgtn,bgth,bghnp->bgthp", cr.to(f32), torch.exp(cum),
                           s_prev)
    return (y_intra + y_inter).reshape(b, s, h, pdim), state


def ssd_steps(xh, bt, ct, a, dt, state):
    """The exact step scan from ``state`` (B, H, N, P) float32; inputs as
    :func:`ssd_chunked`'s.  Returns (y (B, S, H, P), final state)."""
    f32 = torch.float32
    ys = []
    for t in range(xh.shape[1]):
        xt, btt, ctt = xh[:, t].to(f32), bt[:, t].to(f32), ct[:, t].to(f32)
        upd = torch.einsum("bn,bhp->bhnp", btt, xt * dt[:, t, :, None])
        state = state * a[:, t, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", ctt, state))
    return torch.stack(ys, dim=1), state


def _gated(p: dict, x: torch.Tensor, cfg: SSMConfig, d_model: int, state, return_final,
           heads: slice):
    """in_proj, the conv over every channel, the SSD over ``heads``, the
    skip and the gate: (y (B, S, len(heads) P) in x's dtype, new state)."""
    b, s, _ = x.shape
    dt_ = x.dtype
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    z, xin, bc, dtproj = torch.split(x @ p["in_proj"],
                                     [d_inner, d_inner, 2 * cfg.d_state, nh], dim=-1)
    conv_out, conv_state = causal_conv(p, torch.cat([xin, bc], dim=-1),
                                       None if state is None else state.get("conv"))
    xin = conv_out[..., :d_inner]
    bt, ct = conv_out[..., d_inner:].chunk(2, dim=-1)          # (B,S,N) each

    dt_act = F.softplus(dtproj.float() + p["dt_bias"].float())  # (B,S,H)
    a = torch.exp(-dt_act * torch.exp(p["a_log"].float()))
    xh = xin.reshape(b, s, nh, cfg.head_dim)
    d_skip = p["d_skip"].float()
    if heads != slice(0, nh):            # decode on this rank's heads
        xh, a, dt_act, d_skip = xh[:, :, heads], a[:, :, heads], dt_act[:, :, heads], \
            d_skip[heads]
        z = z[..., heads.start * cfg.head_dim:heads.stop * cfg.head_dim]
    hl = xh.shape[2]

    if state is None and s % cfg.chunk == 0 and s > 1:
        y, s_final = ssd_chunked(xh, bt, ct, a, dt_act, cfg.chunk)
        new_state = {"ssm": s_final, "conv": conv_state} if return_final else None
    else:
        ssm = None if state is None else state.get("ssm")
        if ssm is None:
            ssm = torch.zeros(b, hl, cfg.d_state, cfg.head_dim, device=x.device)
        y, ssm = ssd_steps(xh, bt, ct, a, dt_act, ssm)
        new_state = {"ssm": ssm, "conv": conv_state}

    y = y + d_skip[None, None, :, None] * xh.float()
    y = y.reshape(b, s, hl * cfg.head_dim).to(dt_)
    return y * F.silu(z), new_state


def mamba2_ranks(ps: list, xs: list, cfg: SSMConfig, d_model: int, states: list,
                 ranks: list, sp: bool = False):
    """Mamba2 of each rank of a data row (``ps``: its weights, every leaf
    whole: no rule names one).  ``states`` as :func:`mamba2_forward`'s.

    A fresh sequence (train, prefill) runs the whole layer on the gathered
    sequence on every rank, which keeps its own positions with ``sp``
    (prefill's final ``ssm`` state cut to the rank's heads where the heads
    split over "model", as ``cache_specs`` places it; ``conv`` whole).  A
    decode step from a cache whose ``ssm`` holds the rank's heads runs the
    SSD on those heads: the gated RMSNorm over all of d_inner takes its sum
    of squares over "model", and ``out_proj``'s partial products (the
    rank's rows) are summed over "model".  Returns (outs, new states)."""
    comm, r0 = ranks[0].comm, ranks[0]
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    split = r0.M > 1 and nh % r0.M == 0
    fresh = not isinstance(states[0], dict)
    if fresh:
        xs = gather_seq(comm, xs, sp)
    parts = []
    for p, x, state, r in zip(ps, xs, states, ranks):
        final = isinstance(state, str) and state == "final"
        own = (slice(r.m * nh // r.M, (r.m + 1) * nh // r.M) if split and not fresh
               else slice(0, nh))
        y, st = _gated(p, x, cfg, d_model, None if final else state, final, own)
        if final and split:
            st["ssm"] = st["ssm"][:, r.m * nh // r.M:(r.m + 1) * nh // r.M]
        parts.append((y, st, own))
    if split and not fresh:
        sums = comm.sum([y.float().square().sum(-1, keepdim=True) for y, _, _ in parts])
        var = [t / d_inner for t in sums]
    else:
        var = [y.float().square().mean(-1, keepdim=True) for y, _, _ in parts]
    outs = []
    for p, (y, _, own), v in zip(ps, parts, var):
        cols = slice(own.start * cfg.head_dim, own.stop * cfg.head_dim)
        y = (y.float() * torch.rsqrt(v + 1e-6)).to(y.dtype)
        y = y * p["norm_scale"][cols]
        outs.append(y @ p["out_proj"][cols])
    if split and not fresh:
        outs = comm.sum(outs)
    return cut_seq(outs, ranks, sp and fresh), [st for _, st, _ in parts]


def mamba2_forward(p: dict, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                   state=None):
    """x: (B, S, D) -> (out, new_state).

    ``p``: ``in_proj``, ``conv_w``, ``conv_b``, ``out_proj``,
    ``norm_scale`` in x's dtype, ``a_log``/``dt_bias``/``d_skip`` in the
    parameter dtype.  ``state``: None (a fresh sequence; no state out),
    ``"final"`` (a fresh sequence; its final state out, as prefill wants)
    or ``{"ssm": (B, nh, N, P) float32, "conv": (B, K-1, C)}`` to continue
    from (decode).  The new state is ``{"ssm", "conv"}``."""
    (out,), (st,) = mamba2_ranks([p], [x], cfg, d_model, [state], [SOLO])
    return out, st
