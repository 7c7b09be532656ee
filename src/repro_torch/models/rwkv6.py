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

    def forward(self, x, state=None, x_prev=None):
        return time_mix(self.weights(x.dtype, keep=TMIX_RAW), x, self.head_dim,
                        state, x_prev)


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

    def forward(self, x, x_prev=None):
        return channel_mix(self.weights(x.dtype), x, x_prev)


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


def time_mix(p: dict, x: torch.Tensor, head_dim: int, state=None, x_prev=None):
    """RWKV6 time mix.  x: (B, S, D).  Returns (out, (state, x_last)).

    ``p``: ``wr``/``wk``/``wv``/``wg``/``wo``/``mix`` in x's dtype, the
    rest (:data:`TMIX_RAW`) in the parameter dtype.  ``state``: the (B, H,
    K, V) float32 WKV state carried in (zeros when None); ``x_prev``: the
    token-shift carry (B, D)."""
    b, s, d = x.shape
    h = d // head_dim
    dt = x.dtype
    xw_, xs = _shifted(x, x_prev)
    mix = p["mix"]
    xr, xk, xv, xg, xw = (xw_ + mix[i] * (xs - xw_) for i in range(5))

    f32 = torch.float32
    r = _mm(xr, p["wr"]).reshape(b, s, h, head_dim).to(f32)
    k = _mm(xk, p["wk"]).reshape(b, s, h, head_dim).to(f32)
    v = _mm(xv, p["wv"]).reshape(b, s, h, head_dim).to(f32)
    g = F.silu(_mm(xg, p["wg"]))
    w = decay(p, xw).reshape(b, s, h, head_dim)
    u = p["u"].float().reshape(h, head_dim)
    if state is None:
        state = torch.zeros(b, h, head_dim, head_dim, device=x.device)
    if s > WKV_CHUNK and s % WKV_CHUNK == 0:
        o, state = wkv6_chunked(r, k, v, w, u, state)
    else:
        o, state = wkv6_steps(r, k, v, w, u, state)

    # per-head group norm
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, unbiased=False, keepdim=True)
    o = (o - mean) * torch.rsqrt(var + 1e-5) * p["ln_scale"]
    o = o.reshape(b, s, d).to(dt) * g
    return _mm(o, p["wo"]), (state, x[:, -1])


def channel_mix(p: dict, x: torch.Tensor, x_prev=None):
    """RWKV6 channel mix; ``p`` in x's dtype.  Returns (out, x_last)."""
    xw_, xs = _shifted(x, x_prev)
    mix = p["mix"]
    xk = xw_ + mix[0] * (xs - xw_)
    xr = xw_ + mix[1] * (xs - xw_)
    kk = torch.square(torch.relu(_mm(xk, p["wk"])))
    return torch.sigmoid(_mm(xr, p["wr"])) * _mm(kk, p["wv"]), x[:, -1]


class RWKVLayer(nn.Module):
    """One layer of the reference's rwkv6 stack: ``block`` (``tmix``,
    ``cmix``) and its two pre-norms ``norm1``/``norm2``."""

    def __init__(self, d_model: int, d_ff: int, head_dim: int, norm_eps: float, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.norm_eps = norm_eps
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

    def forward(self, x, state=None):
        """x: (B, S, D); ``state``: None (a fresh sequence) or ``{"wkv",
        "tshift1", "tshift2"}``.  Returns (x, new state)."""
        st = state or {}
        att, (wkv, xl1) = self.block["tmix"](rms_norm(x, self.norm1, self.norm_eps),
                                             st.get("wkv"), st.get("tshift1"))
        x = x + att
        ff, xl2 = self.block["cmix"](rms_norm(x, self.norm2, self.norm_eps),
                                     st.get("tshift2"))
        return x + ff, {"wkv": wkv, "tshift1": xl1, "tshift2": xl2}
