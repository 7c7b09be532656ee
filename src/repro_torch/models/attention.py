"""Grouped-query attention with RoPE, softcap, local windows, prefix-LM
masks and a KV cache (the reference's ``repro.models.attention``).

* GQA with any kv-head count (starcoder2 kv=2 ... qwen kv=40=MHA), QKV
  bias (qwen1.5), partial rotary (chatglm3: fraction 0.5), logit softcap
  and local windows (gemma2), prefix-LM masks (paligemma: bidirectional
  over the prefix).
* Full self-attention and prefill run on kernel K3 with its gradient
  (:class:`repro_torch.kernels.flash.FlashAttention`: K3 forward, its
  backward kernel) with the config's window and prefix: causal attention
  with positions 0..S-1 under ``_mask_block``, which is what the
  reference's ``_attend`` computes for them.
* Decode is one query row over the cache in plain torch ops
  (:func:`_attend_dense`, the reference's dense path, window included).
  The reference switches to a blockwise scan for caches longer than 2048;
  both compute the same softmax, so the port uses the dense form for every
  length.

The cache is updated in place (the reference returns a new one): prefill
writes its k/v into the cache it is given and decode writes one slot.

Every pass takes one entry per rank of a data row that this process runs
(``repro_torch.dist.comm``): an unsharded model is one rank (``SOLO``),
whose collectives are the identity.  Across M ranks of "model" each rank
holds the columns of ``wq``/``wk``/``wv`` of its H/M heads and the rows
of ``wo`` (``repro_torch.dist.tp``): the stream is gathered over the
sequence before the projections and the output reduce-scattered back onto
the rank's shard after ``wo`` (an all-reduce in decode).  Where the KV
heads do not divide by M (``"cols"``), each rank's column slice of the k/v
projections is gathered and it attends with the KV heads its own query
heads read; the cache then holds every KV head on every rank.  Where the
query heads do not divide by M (starcoder2's 24, qwen1.5's 40, gemma2's
and paligemma's 8 over the production mesh's 16), ``wq``'s column shard
cuts a head: the q projection is gathered over "model" too, every rank
attends with every head (duplicate work, which the dry-run's useful-FLOPs
ratio shows), and each rank takes its own columns of the output before
``wo``'s row shard (:func:`cut_heads`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dist.comm import SOLO, gather_seq, reduce_seq
from ..kernels import flash
from .layers import CastParams, apply_rope, empty_param, param_init, softcap

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    softcap: float | None = None
    window: int | None = None         # None = global causal
    prefix_len: int = 0               # bidirectional prefix (paligemma)
    query_scale: float | None = None  # None = 1/sqrt(head_dim)

    @property
    def scale(self) -> float:
        return self.query_scale if self.query_scale is not None else 1.0 / float(np.sqrt(self.head_dim))


class Attention(CastParams):
    """The reference's ``init_attn`` parameters: ``wq`` (d, H*hd), ``wk``/
    ``wv`` (d, KVH*hd), ``wo`` (H*hd, d) and, with ``qkv_bias``, ``bq``/
    ``bk``/``bv``."""

    def __init__(self, cfg: AttnConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = empty_param(d, h * hd, **kw)
        self.wk = empty_param(d, kvh * hd, **kw)
        self.wv = empty_param(d, kvh * hd, **kw)
        self.wo = empty_param(h * hd, d, **kw)
        if cfg.qkv_bias:
            self.bq = empty_param(h * hd, **kw)
            self.bk = empty_param(kvh * hd, **kw)
            self.bv = empty_param(kvh * hd, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal x 0.02, ``wo`` x 0.02/sqrt(2), biases 0."""
        for name in ("wq", "wk", "wv"):
            param_init(getattr(self, name), generator)
        param_init(self.wo, generator, scale=0.02 / np.sqrt(2))
        for name in ("bq", "bk", "bv"):
            if name in self._parameters:
                self._parameters[name].zero_()


def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, cfg: AttnConfig):
    """(S,) x (T,) positions -> (S, T) bool visibility: K3's predicate."""
    return flash.visible_mask(q_pos, k_pos, window=cfg.window,
                              prefix_len=cfg.prefix_len)


def _attend_dense(q, k, v, cfg: AttnConfig, q_pos, k_pos, valid=None):
    """q: (B,S,H,hd)  k/v: (B,T,KVH,hd)  q_pos: (S,), k_pos: (T,).

    As the reference: q is scaled in its own dtype (by the scale rounded
    to that dtype, as JAX's weak-typed scalar is), logits and the softmax
    are float32, and the probabilities are cast back before ``p @ v``."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scale = torch.tensor(cfg.scale, dtype=q.dtype).item()
    logits = torch.einsum("bskgd,btkd->bkgst", qg * scale, k).float()
    logits = softcap(logits, cfg.softcap)
    mask = _mask_block(q_pos, k_pos, cfg)
    if valid is not None:                       # decode: cache slots in use
        mask &= valid[None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _attend(q, k, v, cfg: AttnConfig):
    """Attention over positions 0..S-1 under ``_mask_block`` (causal, the
    config's window and prefix): kernel K3, differentiable."""
    return flash.FlashAttention.apply(q, k, v, cfg.scale, cfg.softcap, True,
                                      cfg.window, cfg.prefix_len)


# --------------------------------------------------------------------------
# over the ranks of a data row
# --------------------------------------------------------------------------
def cut_heads(cfg: AttnConfig, M: int) -> bool:
    """Whether ``wq``'s column shard over ``M`` ranks cuts a query head."""
    return M > 1 and cfg.n_heads % M != 0


def _qkv(ps: list, hs: list, cfg: AttnConfig, positions, ranks: list, mode: str):
    """q (B, S, H/M, hd) roped (all H heads where a shard cuts a head:
    the column slices gathered over "model", :func:`cut_heads`), and k, v
    as the cache holds them: (B, S, KVH/M, hd) in ``"heads"`` mode, else
    all KVH heads (``"cols"``: each rank's column slice of the
    projections, gathered over "model").  A rank adds the bias columns of
    its own columns (the stored leaves are whole)."""
    b, s, _ = hs[0].shape
    hd = cfg.head_dim
    cut = cut_heads(cfg, ranks[0].M)
    qs, ks, vs = [], [], []
    for p, h, r in zip(ps, hs, ranks):
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
        if cfg.qkv_bias:
            cols, qcols = p["wk"].shape[1], p["wq"].shape[1]
            kv = slice(r.m * cols, (r.m + 1) * cols) if mode != "whole" else slice(None)
            q = q + p["bq"][r.m * qcols:(r.m + 1) * qcols]
            k = k + p["bk"][kv]
            v = v + p["bv"][kv]
        qs.append(q)
        ks.append(k)
        vs.append(v)
    comm = ranks[0].comm
    if cut:
        qs = comm.gather(qs, -1)
    hq = cfg.n_heads if cut else cfg.n_heads // ranks[0].M
    qs = [apply_rope(q.reshape(b, s, hq, hd), positions, cfg.rope_fraction, cfg.rope_theta)
          for q in qs]
    if mode == "cols":
        ks, vs = comm.gather(ks, -1), comm.gather(vs, -1)
    kvh = cfg.n_kv_heads // ranks[0].M if mode == "heads" else cfg.n_kv_heads
    ks = [apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_fraction, cfg.rope_theta)
          for k in ks]
    return qs, ks, [v.reshape(b, s, kvh, hd) for v in vs]


def kv_for_rank(k: torch.Tensor, cfg: AttnConfig, r, mode: str) -> torch.Tensor:
    """The KV heads (dim 2 of ``k``) that rank ``r``'s query heads read, in
    K3's grouping: a slice where the rank's heads read whole groups of
    KV heads (rank r of starcoder2's 4 reads KV head r // 2), else each KV
    head repeated once per query head."""
    if mode == "heads" or cut_heads(cfg, r.M):
        return k
    g, hl = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // r.M
    first = r.m * hl
    lo, hi = first // g, (first + hl - 1) // g + 1
    n = hi - lo
    if hl % n == 0 and all((first + j) // g - lo == j // (hl // n) for j in range(hl)):
        return k[:, :, lo:hi].contiguous()
    return k.repeat_interleave(g, dim=2)[:, :, first:first + hl].contiguous()


def _out(ps: list, outs: list, ranks: list, sp: bool) -> list:
    """The row-parallel ``wo`` over each rank's heads (its own columns of
    every head's output, where a shard cuts a head), reduced."""
    parts = []
    for p, o, r in zip(ps, outs, ranks):
        o = o.reshape(o.shape[0], o.shape[1], -1)
        rows = p["wo"].shape[0]
        if o.shape[-1] != rows:
            o = o[..., r.m * rows:(r.m + 1) * rows]
        parts.append(o @ p["wo"])
    return reduce_seq(ranks[0].comm, parts, sp)


def attention_ranks(ps: list, hs: list, cfg: AttnConfig, positions, ranks: list,
                    mode: str = "heads", sp: bool = False,
                    caches: list | None = None) -> list:
    """Self-attention (K3) over positions 0..S-1 for each rank's heads
    (``ps``: its weights, ``hs``: its stream, its sequence shard with
    ``sp``), reduced over "model"; with ``caches``, k/v written into slots
    0..S-1 of each rank's (prefill)."""
    qs, ks, vs = _qkv(ps, gather_seq(ranks[0].comm, hs, sp), cfg, positions, ranks, mode)
    outs = []
    for i, (q, k, v, r) in enumerate(zip(qs, ks, vs, ranks)):
        if caches is not None:
            s = k.shape[1]
            caches[i]["k"][:, :s] = k
            caches[i]["v"][:, :s] = v
        outs.append(_attend(q, kv_for_rank(k, cfg, r, mode), kv_for_rank(v, cfg, r, mode),
                            cfg))
    return _out(ps, outs, ranks, sp)


def attention_decode_ranks(ps: list, hs: list, caches: list, index: int, cfg: AttnConfig,
                           ranks: list, mode: str = "heads", ring: bool = False) -> list:
    """One-token decode at position ``index``, the stream whole on every
    rank.  Each rank's cache k/v: (B, T, KVH/M or KVH, hd), written at slot
    ``index``; with ``ring`` a local layer's ring (T = min(max_len,
    window)): the new k/v go to slot index mod T, and slot i holds the
    latest position <= index that maps to it (a negative one is not yet
    written)."""
    b = hs[0].shape[0]
    dev = hs[0].device
    positions = torch.full((b, 1), index, dtype=torch.int64, device=dev)
    qs, ks, vs = _qkv(ps, hs, cfg, positions, ranks, mode)
    outs = []
    for q, k, v, cache, r in zip(qs, ks, vs, caches, ranks):
        t = cache["k"].shape[1]
        if ring:
            slot = index % t
            k_pos = index - (slot - torch.arange(t, device=dev)) % t
            valid = k_pos >= 0
        else:
            if not 0 <= index < t:
                raise ValueError(f"decode index {index} outside the cache of {t}")
            slot, k_pos = index, torch.arange(t, device=dev)
            valid = k_pos <= index
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        kk = kv_for_rank(cache["k"], cfg, r, mode).to(q.dtype)
        vv = kv_for_rank(cache["v"], cfg, r, mode).to(q.dtype)
        outs.append(_attend_dense(q, kk, vv, cfg, torch.full((1,), index, device=dev),
                                  k_pos, valid=valid))
    return _out(ps, outs, ranks, False)


# --------------------------------------------------------------------------
# one rank
# --------------------------------------------------------------------------
def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig, positions):
    (q,), (k,), (v,) = _qkv([p], [x], cfg, positions, [SOLO], "heads")
    return q, k, v


def attention(p: dict, x: torch.Tensor, cfg: AttnConfig, positions):
    """Full self-attention over x: (B, S, D), positions 0..S-1."""
    return attention_ranks([p], [x], cfg, positions, [SOLO])[0]


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros(batch, max_len, kvh, hd, dtype=dtype, device=device),
            "v": torch.zeros(batch, max_len, kvh, hd, dtype=dtype, device=device)}


def attention_prefill(p: dict, x: torch.Tensor, cfg: AttnConfig, positions,
                      cache: dict):
    """Prefill: full attention over x, and k/v written into slots 0..S-1 of
    ``cache`` (k/v (B, max_len, KVH, hd), in its own dtype)."""
    return attention_ranks([p], [x], cfg, positions, [SOLO], caches=[cache])[0]


def attention_decode(p: dict, x: torch.Tensor, cache: dict, index: int,
                     cfg: AttnConfig):
    """One-token decode at position ``index``.  x: (B, 1, D); cache k/v:
    (B, T, KVH, hd), written at slot ``index``."""
    return attention_decode_ranks([p], [x], [cache], index, cfg, [SOLO])[0]
