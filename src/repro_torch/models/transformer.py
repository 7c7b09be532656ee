"""Decoder stack of the dense global family (the reference's
``repro.models.transformer`` for ``family == "dense"`` with
``layer_pattern == "global"``).

The reference scans one stacked (L, ...) parameter pytree with
``lax.scan``; here the layers are an ``nn.ModuleList`` and the scan is a
Python loop.  The KV cache keeps the reference's stacked layout,
``{"layers": {"k": (L, B, T, KVH, hd), "v": ...}}``, so a serving slot is
one index of axis 1 and ``convert`` carries a cache across as it is.
Other families and patterns raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import (
    Attention,
    AttnConfig,
    attention,
    attention_decode,
    attention_prefill,
)
from .config import ModelConfig
from .layers import empty_param, rms_norm
from .mlp import MLP


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless the port has this config's family and layer pattern."""
    if cfg.family != "dense" or cfg.layer_pattern != "global":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layer pattern "
            f"{cfg.layer_pattern!r} is not ported yet; repro_torch serves the "
            "dense family with global attention (ROADMAP.md §1 queues gemma2's "
            "local/global pairs, MoE, RWKV6, Mamba2/zamba2 and the vlm/audio "
            "stubs)")


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


# ==========================================================================
# Stack: init + forward + prefill + decode
# ==========================================================================
def init_stack(cfg: ModelConfig, *, device=None, dtype=torch.float32) -> nn.ModuleList:
    check_supported(cfg)
    return nn.ModuleList(DenseBlock(cfg, device=device, dtype=dtype)
                         for _ in range(cfg.n_layers))


def stack_forward(layers: nn.ModuleList, x, cfg: ModelConfig, positions):
    """Run the full layer stack.  x: (B, S, D).  Returns (x, aux_loss)."""
    acfg = attn_cfg_for(cfg, None)
    for block in layers:
        x = block(x, acfg, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Decode state for one-token serve steps, stacked over layers."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _layer_cache(cache: dict, i: int) -> dict:
    return {"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i]}


def stack_prefill(layers: nn.ModuleList, x, cfg: ModelConfig, positions,
                  max_len: int, cache_dtype=torch.bfloat16):
    """Forward over the prompt, returning (x, decode cache at ``max_len``)."""
    cache = init_cache(cfg, x.shape[0], max_len, cache_dtype, x.device)
    acfg = attn_cfg_for(cfg, None)
    for i, block in enumerate(layers):
        x = block.prefill(x, acfg, positions, _layer_cache(cache, i))
    return x, cache


def stack_decode(layers: nn.ModuleList, x, cache: dict, index: int,
                 cfg: ModelConfig):
    """One-token decode through the stack.  x: (B, 1, D); ``cache`` is
    updated in place and returned."""
    acfg = attn_cfg_for(cfg, None)
    for i, block in enumerate(layers):
        x = block.decode(x, _layer_cache(cache, i), index, acfg)
    return x, cache
