"""Decoder stack of the dense and vlm families (the reference's
``repro.models.transformer`` for ``family in ("dense", "vlm")``), with
global attention or gemma2's local/global alternation.

The reference scans one stacked (L, ...) parameter pytree with
``lax.scan``; here the layers are an ``nn.ModuleList`` and the scan is a
Python loop.  With ``layer_pattern == "local_global"`` each entry is a
:class:`Pair` of a local (windowed) and a global :class:`DenseBlock`, the
reference's ``stack["pairs"]`` superlayer, under its names ``local`` and
``global``.  The KV cache keeps the reference's stacked layout,
``{"layers": {"k": (L, B, T, KVH, hd), "v": ...}}``, or for pairs
``{"local": {"k": (L/2, B, min(T, window), KVH, hd), ...}, "global":
{"k": (L/2, B, T, KVH, hd), ...}}`` with the local layers' k/v in a ring
(position p at slot p mod its length), so a serving slot is one index of
axis 1 and ``convert`` carries a cache across as it is.  A vlm's prefix
(``prefix_len``) attends bidirectionally in forward and prefill, as in
the reference; decode is causal.  Other families raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import (
    Attention,
    AttnConfig,
    _attend_dense,
    _project_qkv,
    attention,
    attention_decode,
    attention_prefill,
    init_kv_cache,
)
from .config import ModelConfig
from .layers import empty_param, rms_norm
from .mlp import MLP


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless the port has this config's family and layer pattern."""
    if cfg.family not in ("dense", "vlm") or cfg.layer_pattern not in (
            "global", "local_global"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layer pattern "
            f"{cfg.layer_pattern!r} is not ported yet; repro_torch serves the "
            "dense and vlm families with global or local/global attention "
            "(ROADMAP.md §1 queues MoE, RWKV6, Mamba2/zamba2 and the audio "
            "stub)")
    if cfg.layer_pattern == "local_global" and cfg.n_layers % 2:
        raise ValueError(f"{cfg.name}: local/global pairs need an even layer "
                         f"count, got {cfg.n_layers}")


def attn_cfg_for(cfg: ModelConfig, window: int | None, prefix_len: int = 0) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        qkv_bias=cfg.qkv_bias,
        rope_fraction=cfg.rope_fraction,
        rope_theta=cfg.rope_theta,
        softcap=cfg.attn_softcap,
        window=window,
        prefix_len=prefix_len,
        query_scale=cfg.query_scale,
    )


class DenseBlock(nn.Module):
    """Attention + MLP with pre-norms, and gemma2's optional post-norms."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.attn = Attention(attn_cfg_for(cfg, None), **kw)
        self.mlp = MLP(d, cfg.dense_ff or cfg.d_ff, cfg.mlp, **kw)
        self.norm_attn = empty_param(d, **kw)
        self.norm_mlp = empty_param(d, **kw)
        if cfg.post_norms:
            self.post_attn = empty_param(d, **kw)
            self.post_mlp = empty_param(d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        # gemma "1 + w" norms start at 0
        for name in ("norm_attn", "norm_mlp"):
            getattr(self, name).fill_(0.0 if self.cfg.post_norms else 1.0)
        if self.cfg.post_norms:
            self.post_attn.zero_()
            self.post_mlp.zero_()

    def _norm(self, name: str, x, plus_one: bool):
        return rms_norm(x, getattr(self, name), self.cfg.norm_eps, plus_one)

    def _residual(self, x, attend):
        """x + attention sublayer, then + MLP sublayer; ``attend`` maps the
        normed input and the attention weights to the attention output."""
        post = self.cfg.post_norms
        a = attend(self._norm("norm_attn", x, post), self.attn.weights(x.dtype))
        if post:
            a = self._norm("post_attn", a, True)
        x = x + a
        m = self.mlp(self._norm("norm_mlp", x, post))
        if post:
            m = self._norm("post_mlp", m, True)
        return x + m

    def forward(self, x, acfg: AttnConfig, positions):
        return self._residual(x, lambda h, p: attention(p, h, acfg, positions))

    def prefill(self, x, acfg: AttnConfig, positions, cache: dict):
        return self._residual(
            x, lambda h, p: attention_prefill(p, h, acfg, positions, cache))

    def decode(self, x, cache: dict, index: int, acfg: AttnConfig):
        return self._residual(
            x, lambda h, p: attention_decode(p, h, cache, index, acfg))


class Pair(nn.ModuleDict):
    """gemma2's superlayer: a local (windowed) block, then a global one."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__({name: DenseBlock(cfg, device=device, dtype=dtype)
                          for name in ("local", "global")})

    def reset_parameters(self, generator: torch.Generator) -> None:
        for block in self.values():
            block.reset_parameters(generator)


def _decode_ring(block: DenseBlock, x, cache: dict, index: int, acfg: AttnConfig):
    """One-token decode of a local block against its ring cache (k/v (B,
    W, KVH, hd), W = min(max_len, window)): the new k/v go to slot index
    mod W, and slot i holds the latest position <= index that maps to it
    (a negative one is not yet written)."""
    def attend(h, p):
        b = h.shape[0]
        tlen = cache["k"].shape[1]
        positions = torch.full((b, 1), index, dtype=torch.int64, device=h.device)
        q, k, v = _project_qkv(p, h, acfg, positions)
        slot = index % tlen
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        age = (slot - torch.arange(tlen, device=h.device)) % tlen   # 0 = newest
        k_pos = index - age
        q_pos = torch.full((1,), index, device=h.device)
        out = _attend_dense(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), acfg,
                            q_pos, k_pos, valid=k_pos >= 0)
        return out.reshape(b, 1, acfg.n_heads * acfg.head_dim) @ p["wo"]

    return block._residual(x, attend)


def _ring_from_full(cache: dict, s: int, local_len: int) -> dict:
    """The last min(s, local_len) k/v entries of a prefill cache (k/v (B,
    >= s, KVH, hd), entries 0..s-1 written) laid out at ring slots (pos mod
    local_len); the other slots are zero."""
    take = min(s, local_len)
    start = s - take
    slots = (start + torch.arange(take, device=cache["k"].device)) % local_len

    def fold(a):
        out = a.new_zeros((a.shape[0], local_len) + tuple(a.shape[2:]))
        out[:, slots] = a[:, start:s]
        return out

    return {"k": fold(cache["k"]), "v": fold(cache["v"])}


# ==========================================================================
# Stack: init + forward + prefill + decode
# ==========================================================================
def init_stack(cfg: ModelConfig, *, device=None, dtype=torch.float32) -> nn.ModuleList:
    check_supported(cfg)
    if cfg.layer_pattern == "local_global":
        return nn.ModuleList(Pair(cfg, device=device, dtype=dtype)
                             for _ in range(cfg.n_layers // 2))
    return nn.ModuleList(DenseBlock(cfg, device=device, dtype=dtype)
                         for _ in range(cfg.n_layers))


def _pair_cfgs(cfg: ModelConfig, prefix_len: int = 0):
    return (attn_cfg_for(cfg, cfg.local_window, prefix_len),
            attn_cfg_for(cfg, None, prefix_len))


def stack_forward(layers: nn.ModuleList, x, cfg: ModelConfig, positions,
                  prefix_len: int = 0):
    """Run the full layer stack.  x: (B, S, D).  Returns (x, aux_loss)."""
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg, prefix_len)
        for pair in layers:
            x = pair["local"](x, a_loc, positions)
            x = pair["global"](x, a_glo, positions)
    else:
        acfg = attn_cfg_for(cfg, None, prefix_len)
        for block in layers:
            x = block(x, acfg, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _local_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.local_window or max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Decode state for one-token serve steps, stacked over layers."""
    check_supported(cfg)

    def kv(n, length):
        shape = (n, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.layer_pattern == "local_global":
        half = cfg.n_layers // 2
        return {"local": kv(half, _local_len(cfg, max_len)),
                "global": kv(half, max_len)}
    return {"layers": kv(cfg.n_layers, max_len)}


def _layer_cache(group: dict, i: int) -> dict:
    """Layer ``i``'s k/v (views) of one stacked group of the cache."""
    return {"k": group["k"][i], "v": group["v"][i]}


def stack_prefill(layers: nn.ModuleList, x, cfg: ModelConfig, positions,
                  max_len: int, cache_dtype=torch.bfloat16, prefix_len: int = 0):
    """Forward over the prompt, returning (x, decode cache at ``max_len``)."""
    cache = init_cache(cfg, x.shape[0], max_len, cache_dtype, x.device)
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg, prefix_len)
        b, s = x.shape[:2]
        for i, pair in enumerate(layers):
            # the local layer's k/v at full length, folded into its ring
            full = init_kv_cache(b, s, a_loc, cache_dtype, x.device)
            x = pair["local"].prefill(x, a_loc, positions, full)
            ring = _ring_from_full(full, s, _local_len(cfg, max_len))
            for name in ("k", "v"):
                cache["local"][name][i] = ring[name]
            x = pair["global"].prefill(x, a_glo, positions,
                                       _layer_cache(cache["global"], i))
        return x, cache
    acfg = attn_cfg_for(cfg, None, prefix_len)
    for i, block in enumerate(layers):
        x = block.prefill(x, acfg, positions, _layer_cache(cache["layers"], i))
    return x, cache


def stack_decode(layers: nn.ModuleList, x, cache: dict, index: int,
                 cfg: ModelConfig):
    """One-token decode through the stack.  x: (B, 1, D); ``cache`` is
    updated in place and returned."""
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg)
        for i, pair in enumerate(layers):
            x = _decode_ring(pair["local"], x, _layer_cache(cache["local"], i),
                             index, a_loc)
            x = pair["global"].decode(x, _layer_cache(cache["global"], i), index,
                                      a_glo)
        return x, cache
    acfg = attn_cfg_for(cfg, None)
    for i, block in enumerate(layers):
        x = block.decode(x, _layer_cache(cache["layers"], i), index, acfg)
    return x, cache
