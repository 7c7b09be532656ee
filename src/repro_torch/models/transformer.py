"""Decoder stacks of every family (the reference's
``repro.models.transformer``): dense, vlm and audio (global attention or
gemma2's local/global alternation), moe, ssm (rwkv6) and hybrid (zamba2).

The reference scans stacked (L, ...) parameter pytrees with ``lax.scan``;
here the layers are ``nn.ModuleList``s and the scan is a Python loop.
``init_stack`` gives, by family:

* dense/vlm: a list of :class:`DenseBlock`, or with ``layer_pattern ==
  "local_global"`` of :class:`Pair` (a local, windowed block and a global
  one, the reference's ``stack["pairs"]`` superlayer);
* moe: ``{"dense_layers": first_dense DenseBlocks, "moe_layers": the other
  layers as MoEBlocks}`` (no ``dense_layers`` when ``first_dense`` is 0);
* ssm: a list of :class:`~repro_torch.models.rwkv6.RWKVLayer`;
* hybrid: ``{"mamba": L MambaLayers, "shared": one SharedAttn, "lora":
  L / attn_every LoRA sets}``; mamba layer i belongs to group i //
  attn_every, and the shared block runs after each group's last layer
  with that group's LoRA deltas folded into its q/k/v weights.

Caches keep the reference's stacked layouts, so a serving slot is one
index of axis 1 of every leaf and ``convert`` carries a cache across as it
is: ``{"layers": kv}`` or ``{"local": ring kv, "global": kv}`` (dense),
``{"dense_layers": kv, "moe_layers": kv}`` (moe), ``{"wkv": (L, B, H, K,
V) float32, "tshift1", "tshift2": (L, B, D)}`` (ssm), ``{"ssm": (L, B,
nh, N, P) float32, "conv": (L, B, K-1, C), "attn_kv": kv over the
groups}`` (hybrid), where kv is ``{"k", "v"}`` of (n, B, T, KVH, hd) and
gemma2's local ring holds position p at slot p mod its length.  Prefill
returns the states as the reference does (the recurrent ones in float32
and the compute dtype, the k/v in the cache dtype); decode writes each
layer's new state into the cache it is given.  A vlm's prefix
(``prefix_len``) attends bidirectionally in forward and prefill; decode
is causal.  The audio family's stack is the dense one.

Where autograd records, ``stack_forward`` runs each scanned body of the
reference under ``torch.utils.checkpoint`` (its ``jax.checkpoint``): a
dense or MoE block, a local/global pair, an rwkv6 layer, and zamba2's
group of ``attn_every`` Mamba2 layers with the shared block and the
group's LoRA.  Only each body's input is kept, and the backward runs the
body's forward again, so a MoE layer's recompute must route as its first
forward did: the dispatch sorts stably and the combine sums in a fixed
order.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from .layers import CastParams, empty_param, param_init, rms_norm
from .mamba2 import Mamba2
from .mlp import MLP
from .moe import MoE
from .rwkv6 import RWKVLayer

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
LORA_RANK = 128      # zamba2's per-invocation adapter rank


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless the port has this config's family and layer pattern."""
    patterns = ("global", "local_global") if cfg.family in ("dense", "vlm") else ("global",)
    if cfg.family not in FAMILIES or cfg.layer_pattern not in patterns:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layer pattern "
            f"{cfg.layer_pattern!r} is not ported; repro_torch has the dense "
            "and vlm families with global or local/global attention, the "
            "audio family with global attention and the moe, ssm (rwkv6) and "
            "hybrid (zamba2) families")
    if cfg.layer_pattern == "local_global" and cfg.n_layers % 2:
        raise ValueError(f"{cfg.name}: local/global pairs need an even layer "
                         f"count, got {cfg.n_layers}")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} mamba layers do not split "
                         f"into groups of {cfg.attn_every}")


def _remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where autograd
    records."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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

    def forward(self, x, a_loc: AttnConfig, a_glo: AttnConfig, positions):
        x = self["local"](x, a_loc, positions)
        return self["global"](x, a_glo, positions)

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


class MoEBlock(nn.Module):
    """Attention + the MoE FFN, with pre-norms (the reference's
    ``moe_block``); its forward also returns the layer's aux loss."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.attn = Attention(attn_cfg_for(cfg, None), **kw)
        self.moe = MoE(d, cfg.d_ff, cfg.moe, cfg.mlp, **kw)
        self.norm_attn = empty_param(d, **kw)
        self.norm_mlp = empty_param(d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.moe.reset_parameters(generator)
        self.norm_attn.fill_(1.0)
        self.norm_mlp.fill_(1.0)

    def _residual(self, x, attend):
        eps = self.cfg.norm_eps
        x = x + attend(rms_norm(x, self.norm_attn, eps), self.attn.weights(x.dtype))
        m, aux = self.moe(rms_norm(x, self.norm_mlp, eps))
        return x + m, aux

    def forward(self, x, acfg: AttnConfig, positions):
        return self._residual(x, lambda h, p: attention(p, h, acfg, positions))

    def prefill(self, x, acfg: AttnConfig, positions, cache: dict):
        return self._residual(
            x, lambda h, p: attention_prefill(p, h, acfg, positions, cache))[0]

    def decode(self, x, cache: dict, index: int, acfg: AttnConfig):
        return self._residual(
            x, lambda h, p: attention_decode(p, h, cache, index, acfg))[0]


class MambaLayer(nn.Module):
    """A Mamba2 block under its pre-norm, with the residual."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.ssm = Mamba2(cfg.d_model, cfg.ssm, device=device, dtype=dtype)
        self.norm = empty_param(cfg.d_model, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ssm.reset_parameters(generator)
        self.norm.fill_(1.0)

    def forward(self, x, state=None):
        y, new_state = self.ssm(rms_norm(x, self.norm, self.cfg.norm_eps), state)
        return x + y, new_state


class LoraDelta(CastParams):
    """One projection's adapter: ``a`` (2 d, r) and ``b`` (r, out)."""

    def __init__(self, d_in: int, d_out: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.a = empty_param(d_in, LORA_RANK, device=device, dtype=dtype)
        self.b = empty_param(LORA_RANK, d_out, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``a`` normal x 0.02, ``b`` zeros (the reference's init: the
        adapters start as no change)."""
        param_init(self.a, generator)
        self.b.zero_()

    def delta(self, dtype: torch.dtype) -> torch.Tensor:
        return self.cast("a", dtype) @ self.cast("b", dtype)


class Lora(nn.ModuleDict):
    """One invocation's adapters of the shared block's q, k and v."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        d2, kw = 2 * cfg.d_model, dict(device=device, dtype=dtype)
        super().__init__({"q": LoraDelta(d2, cfg.n_heads * cfg.hd, **kw),
                          "k": LoraDelta(d2, cfg.n_kv_heads * cfg.hd, **kw),
                          "v": LoraDelta(d2, cfg.n_kv_heads * cfg.hd, **kw)})

    def reset_parameters(self, generator: torch.Generator) -> None:
        for delta in self.values():
            delta.reset_parameters(generator)


class SharedAttn(nn.Module):
    """zamba2's single shared attention + MLP block.  Its input is
    concat([x, x0]) (x0 the embedding stream), so q/k/v read 2 d_model and
    ``wo`` maps back to d_model; each invocation folds its LoRA deltas into
    q/k/v in the compute dtype (the reference's ``_lora_weights``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.attn = Attention(dataclasses.replace(attn_cfg_for(cfg, None), d_model=2 * d),
                              **kw)
        self.attn.wo = empty_param(cfg.n_heads * cfg.hd, d, **kw)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, **kw)
        self.norm_attn = empty_param(2 * d, **kw)
        self.norm_mlp = empty_param(d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.norm_attn.fill_(1.0)
        self.norm_mlp.fill_(1.0)

    def _residual(self, x, x0, lora: Lora, attend):
        eps = self.cfg.norm_eps
        h2 = rms_norm(torch.cat([x, x0], dim=-1), self.norm_attn, eps)
        p = self.attn.weights(h2.dtype)
        for name in ("q", "k", "v"):
            p["w" + name] = p["w" + name] + lora[name].delta(h2.dtype)
        x = x + attend(h2, p)
        return x + self.mlp(rms_norm(x, self.norm_mlp, eps))

    def forward(self, x, x0, lora: Lora, acfg: AttnConfig, positions):
        return self._residual(x, x0, lora,
                              lambda h, p: attention(p, h, acfg, positions))

    def prefill(self, x, x0, lora: Lora, acfg: AttnConfig, positions, cache: dict):
        return self._residual(
            x, x0, lora, lambda h, p: attention_prefill(p, h, acfg, positions, cache))

    def decode(self, x, x0, lora: Lora, cache: dict, index: int, acfg: AttnConfig):
        return self._residual(
            x, x0, lora, lambda h, p: attention_decode(p, h, cache, index, acfg))


# ==========================================================================
# Stack: init + forward + prefill + decode
# ==========================================================================
def init_stack(cfg: ModelConfig, *, device=None, dtype=torch.float32) -> nn.Module:
    """The family's layers (see the module docstring)."""
    check_supported(cfg)
    kw = dict(device=device, dtype=dtype)
    if cfg.family == "moe":
        parts = {"moe_layers": nn.ModuleList(
            MoEBlock(cfg, **kw) for _ in range(cfg.n_layers - cfg.first_dense))}
        if cfg.first_dense:
            parts = {"dense_layers": nn.ModuleList(
                DenseBlock(cfg, **kw) for _ in range(cfg.first_dense)), **parts}
        return nn.ModuleDict(parts)
    if cfg.family == "ssm":
        return nn.ModuleList(RWKVLayer(cfg.d_model, cfg.d_ff, cfg.ssm.head_dim,
                                       cfg.norm_eps, **kw)
                             for _ in range(cfg.n_layers))
    if cfg.family == "hybrid":
        return nn.ModuleDict({
            "mamba": nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(cfg.n_layers)),
            "shared": SharedAttn(cfg, **kw),
            "lora": nn.ModuleList(Lora(cfg, **kw) for _ in range(_groups(cfg)))})
    if cfg.layer_pattern == "local_global":
        return nn.ModuleList(Pair(cfg, **kw) for _ in range(cfg.n_layers // 2))
    return nn.ModuleList(DenseBlock(cfg, **kw) for _ in range(cfg.n_layers))


def reset_stack(layers: nn.Module, generator: torch.Generator) -> None:
    """Draw every layer's parameters from ``generator``."""
    parts = layers.values() if isinstance(layers, nn.ModuleDict) else [layers]
    for part in parts:
        for block in (part if isinstance(part, nn.ModuleList) else [part]):
            block.reset_parameters(generator)


def _groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def _group_layers(cfg: ModelConfig, g: int) -> range:
    """The mamba layers of group ``g`` (the shared block follows them)."""
    return range(g * cfg.attn_every, (g + 1) * cfg.attn_every)


def _dense_layers(layers: nn.ModuleDict):
    return layers["dense_layers"] if "dense_layers" in layers else ()


def _pair_cfgs(cfg: ModelConfig, prefix_len: int = 0):
    return (attn_cfg_for(cfg, cfg.local_window, prefix_len),
            attn_cfg_for(cfg, None, prefix_len))


def _hybrid_group(layers: nn.ModuleDict, cfg: ModelConfig, g: int, x, x0,
                  acfg: AttnConfig, positions):
    """Group ``g`` of zamba2's stack: its Mamba2 layers, then the shared
    block with the group's LoRA (the reference's ``gbody``)."""
    for i in _group_layers(cfg, g):
        x, _ = layers["mamba"][i](x)
    return layers["shared"](x, x0, layers["lora"][g], acfg, positions)


def stack_forward(layers: nn.Module, x, cfg: ModelConfig, positions,
                  prefix_len: int = 0):
    """Run the full layer stack, each body checkpointed (the module
    docstring).  x: (B, S, D).  Returns (x, aux_loss): the sum of the MoE
    layers' aux losses, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    acfg = attn_cfg_for(cfg, None, prefix_len)
    if cfg.family == "moe":
        for block in _dense_layers(layers):
            x = _remat(block, x, acfg, positions)
        for block in layers["moe_layers"]:
            x, a = _remat(block, x, acfg, positions)
            aux = aux + a
    elif cfg.family == "ssm":
        for layer in layers:
            x, _ = _remat(layer, x)
    elif cfg.family == "hybrid":
        x0 = x
        for g in range(_groups(cfg)):
            x = _remat(_hybrid_group, layers, cfg, g, x, x0, acfg, positions)
    elif cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg, prefix_len)
        for pair in layers:
            x = _remat(pair, x, a_loc, a_glo, positions)
    else:
        for block in layers:
            x = _remat(block, x, acfg, positions)
    return x, aux


def _local_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.local_window or max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Decode state for one-token serve steps, stacked over layers."""
    check_supported(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def kv(n, length):
        shape = (n, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    if cfg.family == "moe":
        out = {"moe_layers": kv(cfg.n_layers - cfg.first_dense, max_len)}
        if cfg.first_dense:
            out["dense_layers"] = kv(cfg.first_dense, max_len)
        return out
    if cfg.family == "ssm":
        d, hd, n = cfg.d_model, cfg.ssm.head_dim, cfg.n_layers
        return {"wkv": zeros(n, batch, d // hd, hd, hd, dt=torch.float32),
                "tshift1": zeros(n, batch, d), "tshift2": zeros(n, batch, d)}
    if cfg.family == "hybrid":
        sc = cfg.ssm
        d_inner = sc.expand * cfg.d_model
        return {"ssm": zeros(cfg.n_layers, batch, d_inner // sc.head_dim, sc.d_state,
                             sc.head_dim, dt=torch.float32),
                "conv": zeros(cfg.n_layers, batch, sc.d_conv - 1, d_inner + 2 * sc.d_state),
                "attn_kv": kv(_groups(cfg), max_len)}
    if cfg.layer_pattern == "local_global":
        half = cfg.n_layers // 2
        return {"local": kv(half, _local_len(cfg, max_len)),
                "global": kv(half, max_len)}
    return {"layers": kv(cfg.n_layers, max_len)}


def _layer_cache(group: dict, i: int) -> dict:
    """Layer ``i``'s entries (views) of one stacked group of the cache."""
    return {name: leaf[i] for name, leaf in group.items()}


def _stacked(states: list[dict]) -> dict:
    """Per-layer state dicts stacked on a new leading axis."""
    return {name: torch.stack([st[name] for st in states]) for name in states[0]}


def stack_prefill(layers: nn.Module, x, cfg: ModelConfig, positions,
                  max_len: int, cache_dtype=torch.bfloat16, prefix_len: int = 0):
    """Forward over the prompt, returning (x, decode cache at ``max_len``):
    k/v in ``cache_dtype``; rwkv6's and Mamba2's states as their layers
    leave them (float32 recurrent states, the token-shift carries and the
    conv inputs in the compute dtype), as the reference's prefill does."""
    acfg = attn_cfg_for(cfg, None, prefix_len)
    if cfg.family == "ssm":
        states = []
        for layer in layers:
            x, st = layer(x)
            states.append(st)
        return x, _stacked(states)
    if cfg.family == "hybrid":
        x0, states = x, []
        cache = {"attn_kv": init_cache(cfg, x.shape[0], max_len, cache_dtype,
                                       x.device)["attn_kv"]}
        for g, lora in enumerate(layers["lora"]):
            for i in _group_layers(cfg, g):
                x, st = layers["mamba"][i](x, "final")
                states.append(st)
            x = layers["shared"].prefill(x, x0, lora, acfg, positions,
                                         _layer_cache(cache["attn_kv"], g))
        return x, {**_stacked(states), **cache}
    cache = init_cache(cfg, x.shape[0], max_len, cache_dtype, x.device)
    if cfg.family == "moe":
        for name, group in (("dense_layers", _dense_layers(layers)),
                            ("moe_layers", layers["moe_layers"])):
            for i, block in enumerate(group):
                x = block.prefill(x, acfg, positions, _layer_cache(cache[name], i))
        return x, cache
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
    for i, block in enumerate(layers):
        x = block.prefill(x, acfg, positions, _layer_cache(cache["layers"], i))
    return x, cache


def _write(cache: dict, i: int, state: dict) -> None:
    """Layer ``i``'s new state into the stacked cache, in its dtypes."""
    for name, value in state.items():
        cache[name][i] = value


def stack_decode(layers: nn.Module, x, cache: dict, index: int,
                 cfg: ModelConfig):
    """One-token decode through the stack.  x: (B, 1, D); ``cache`` is
    updated in place and returned.  The recurrent states ignore
    ``index``."""
    acfg = attn_cfg_for(cfg, None)
    if cfg.family == "moe":
        for name, group in (("dense_layers", _dense_layers(layers)),
                            ("moe_layers", layers["moe_layers"])):
            for i, block in enumerate(group):
                x = block.decode(x, _layer_cache(cache[name], i), index, acfg)
        return x, cache
    if cfg.family == "ssm":
        for i, layer in enumerate(layers):
            x, st = layer(x, _layer_cache(cache, i))
            _write(cache, i, st)
        return x, cache
    if cfg.family == "hybrid":
        x0 = x
        for g, lora in enumerate(layers["lora"]):
            for i in _group_layers(cfg, g):
                x, st = layers["mamba"][i](x, {"ssm": cache["ssm"][i],
                                               "conv": cache["conv"][i]})
                _write(cache, i, st)
            x = layers["shared"].decode(x, x0, lora, _layer_cache(cache["attn_kv"], g),
                                        index, acfg)
        return x, cache
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg)
        for i, pair in enumerate(layers):
            x = _decode_ring(pair["local"], x, _layer_cache(cache["local"], i),
                             index, a_loc)
            x = pair["global"].decode(x, _layer_cache(cache["global"], i), index,
                                      a_glo)
        return x, cache
    for i, block in enumerate(layers):
        x = block.decode(x, _layer_cache(cache["layers"], i), index, acfg)
    return x, cache
