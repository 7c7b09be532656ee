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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_fraction,
                   cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_fraction,
                   cfg.rope_theta)
    return q, k, v.reshape(b, s, kvh, hd)


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
# public entry points
# --------------------------------------------------------------------------
def attention(p: dict, x: torch.Tensor, cfg: AttnConfig, positions):
    """Full self-attention over x: (B, S, D), positions 0..S-1."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _attend(q, k, v, cfg).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"]


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros(batch, max_len, kvh, hd, dtype=dtype, device=device),
            "v": torch.zeros(batch, max_len, kvh, hd, dtype=dtype, device=device)}


def attention_prefill(p: dict, x: torch.Tensor, cfg: AttnConfig, positions,
                      cache: dict):
    """Prefill: full attention over x, and k/v written into slots 0..S-1 of
    ``cache`` (k/v (B, max_len, KVH, hd), in its own dtype)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _attend(q, k, v, cfg).reshape(b, s, cfg.n_heads * cfg.head_dim)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return out @ p["wo"]


def attention_decode(p: dict, x: torch.Tensor, cache: dict, index: int,
                     cfg: AttnConfig):
    """One-token decode at position ``index``.  x: (B, 1, D); cache k/v:
    (B, T, KVH, hd), written at slot ``index``."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    if not 0 <= index < t:
        raise ValueError(f"decode index {index} outside the cache of {t}")
    positions = torch.full((b, 1), index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache["k"][:, index] = k[:, 0]
    cache["v"][:, index] = v[:, 0]
    k_pos = torch.arange(t, device=x.device)
    q_pos = torch.full((1,), index, device=x.device)
    out = _attend_dense(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), cfg,
                        q_pos, k_pos, valid=k_pos <= index)
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
