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

The dense and moe passes (blocks, local/global pairs, the stacks) take
one entry per rank of a data row that this process runs: an unsharded
model is one rank (``repro_torch.dist.comm.SOLO``, its collectives the
identity), a model across "model" ranks M of them (``repro_torch.dist.
tp``), each block holding its rank's heads and ff and each stream its
sequence shard where the sequence splits (train and prefill; whole in
decode).  The ssm and hybrid families run as one rank.

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

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.comm import SOLO
from .attention import (
    Attention,
    AttnConfig,
    attention,
    attention_decode,
    attention_decode_ranks,
    attention_prefill,
    attention_ranks,
    init_kv_cache,
)
from .config import ModelConfig
from .layers import CastParams, empty_param, param_init, rms_norm
from .mamba2 import Mamba2
from .mlp import MLP, mlp_ranks
from .moe import MoE, moe_ranks
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


def _remat(fn, *args, **kw):
    """``fn(*args, **kw)``, under ``torch.utils.checkpoint`` where autograd
    records."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


@contextlib.contextmanager
def unsharded(*modules):
    """Around a serving call: each FSDP unit among ``modules`` gathered
    (its parameters are sharded over "data" between calls), then freed."""
    from torch.distributed.fsdp import FSDPModule

    units = [m for m in modules if isinstance(m, FSDPModule)]
    for unit in units:
        unit.unshard()
    try:
        yield
    finally:
        for unit in units:
            unit.reshard()


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
    """Attention + MLP with pre-norms, and gemma2's optional post-norms.
    ``tp`` is its rank (``repro_torch.dist.comm.Rank``; ``SOLO`` when
    unsharded); its forward takes the rank's stream (``sp``: its sequence
    shard)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.tp = cfg, SOLO
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

    def forward(self, x, acfg: AttnConfig, positions, sp: bool = False):
        return body_forward([self], [x], acfg, positions, sp=sp)[0]


class Pair(nn.ModuleDict):
    """gemma2's superlayer: a local (windowed) block, then a global one."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__({name: DenseBlock(cfg, device=device, dtype=dtype)
                          for name in ("local", "global")})

    def forward(self, x, a_loc: AttnConfig, a_glo: AttnConfig, positions,
                sp: bool = False):
        return body_forward([self], [x], a_loc, a_glo, positions, sp=sp)[0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        for block in self.values():
            block.reset_parameters(generator)


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
    ``moe_block``); its forward also returns the layer's aux loss.  ``tp``
    as :class:`DenseBlock`'s."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.tp = cfg, SOLO
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

    def forward(self, x, acfg: AttnConfig, positions, sp: bool = False):
        outs, auxs = body_forward([self], [x], acfg, positions, sp=sp)
        return outs[0], auxs[0]


# --------------------------------------------------------------------------
# the blocks of the ranks of a data row
# --------------------------------------------------------------------------
def kv_mode(block) -> str:
    """How a block's rank holds K and V: ``"heads"`` (its own KV heads;
    all of them at M = 1), ``"cols"`` (a column slice of the projections,
    all-gathered over "model") or ``"whole"`` (the projections unsplit)."""
    M = block.tp.M
    if M == 1:
        return "heads"
    if "wk" not in getattr(block.attn, "tp_split", ()):
        return "whole"
    return "heads" if block.cfg.n_kv_heads % M == 0 else "cols"


def kv_heads(block) -> int:
    """The KV heads a block's rank caches (``cache_specs``)."""
    n = block.cfg.n_kv_heads
    return n // block.tp.M if kv_mode(block) == "heads" else n


def _weights(blocks: list, xs: list) -> list:
    return [b.attn.weights(x.dtype) for b, x in zip(blocks, xs)]


def dense_block(blocks: list, xs: list, attend, sp: bool) -> list:
    """A dense block of each rank over its stream: x + the attention
    sublayer, then + the MLP sublayer; ``attend(hs, ps)`` maps the normed
    streams and the attention weights to the attention output, reduced."""
    b0 = blocks[0]
    post = b0.cfg.post_norms
    a = attend([b._norm("norm_attn", x, post) for b, x in zip(blocks, xs)],
               _weights(blocks, xs))
    if post:
        a = [b._norm("post_attn", t, True) for b, t in zip(blocks, a)]
    xs = [x + t for x, t in zip(xs, a)]
    hs = [b._norm("norm_mlp", x, post) for b, x in zip(blocks, xs)]
    split = "up" in getattr(b0.mlp, "tp_split", ())
    m = mlp_ranks([b.mlp.weights(h.dtype) for b, h in zip(blocks, hs)], hs, b0.mlp.kind,
                  [b.tp for b in blocks], sp, split)
    if post:
        m = [b._norm("post_mlp", t, True) for b, t in zip(blocks, m)]
    return [x + t for x, t in zip(xs, m)]


def moe_block(blocks: list, xs: list, attend, sp: bool):
    """A MoE block of each rank (``attend`` as :func:`dense_block`'s);
    returns (streams, aux losses)."""
    eps = blocks[0].cfg.norm_eps
    hs = [rms_norm(x, b.norm_attn, eps) for b, x in zip(blocks, xs)]
    xs = [x + t for x, t in zip(xs, attend(hs, _weights(blocks, xs)))]
    hs = [rms_norm(x, b.norm_mlp, eps) for b, x in zip(blocks, xs)]
    if len(blocks) == 1:                   # one rank: through the module
        out, aux = blocks[0].moe(hs[0], blocks[0].tp, sp)
        outs, auxs = [out], [aux]
    else:
        outs, auxs = moe_ranks([b.moe for b in blocks], hs, [b.tp for b in blocks], sp)
    return [x + o for x, o in zip(xs, outs)], auxs


def _block(blocks: list, xs: list, attend, sp: bool):
    if isinstance(blocks[0], MoEBlock):
        return moe_block(blocks, xs, attend, sp)
    return dense_block(blocks, xs, attend, sp)


def _attend_fn(blocks: list, acfg: AttnConfig, positions, sp: bool, caches=None):
    """Self-attention (K3) for ``blocks``; with ``caches`` (one a rank),
    prefill's k/v written into them."""
    ranks, mode = [b.tp for b in blocks], kv_mode(blocks[0])
    return lambda hs, ps: attention_ranks(ps, hs, acfg, positions, ranks, mode, sp, caches)


def _decode_fn(blocks: list, caches: list, index: int, acfg: AttnConfig, ring=False):
    """One-token decode attention for ``blocks`` over each rank's cache (a
    local layer's ring with ``ring``)."""
    ranks, mode = [b.tp for b in blocks], kv_mode(blocks[0])
    return lambda hs, ps: attention_decode_ranks(ps, hs, caches, index, acfg, ranks, mode,
                                                 ring)


def body_forward(bodies: list, xs: list, *args, sp: bool):
    """One scanned body of each rank (a dense or MoE block: ``args`` =
    (acfg, positions); a gemma2 pair: (a_loc, a_glo, positions)).  A MoE
    block returns (streams, aux losses)."""
    if isinstance(bodies[0], Pair):
        a_loc, a_glo, positions = args
        for part, acfg in (("local", a_loc), ("global", a_glo)):
            blocks = [p[part] for p in bodies]
            xs = dense_block(blocks, xs, _attend_fn(blocks, acfg, positions, sp), sp)
        return xs
    acfg, positions = args
    return _block(bodies, xs, _attend_fn(bodies, acfg, positions, sp), sp)


def _run_body(bodies: list, xs: list, *args, sp: bool):
    """A body of each rank, checkpointed where autograd records: one
    rank's through the module (an FSDP unit gathers its parameters around
    the call), several ranks' in one call."""
    if len(bodies) == 1:
        out = _remat(bodies[0], xs[0], *args, sp=sp)
        return ([out[0]], [out[1]]) if isinstance(out, tuple) else [out]
    return _remat(body_forward, bodies, xs, *args, sp=sp)


def _block_groups(layers: list) -> list:
    """(its cache's key, each rank's list of blocks) of each group of a
    dense or moe stack (``layers``: one a rank), in order."""
    if isinstance(layers[0], nn.ModuleDict):
        return [(name, [group[name] for group in layers])
                for name in ("dense_layers", "moe_layers") if name in layers[0]]
    return [("layers", layers)]


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


def stack_forward(layers: list, xs: list, cfg: ModelConfig, positions,
                  prefix_len: int = 0, sp: bool = False):
    """Run the full layer stack of each rank, each body checkpointed (the
    module docstring).  ``layers``/``xs``: one a rank (one rank outside
    the dense and moe families), xs (B, S, D), or (B, S/M, D) with ``sp``;
    ``positions``: the whole sequence's.  Returns (xs, auxs): each rank's
    stream and the sum of its MoE layers' aux losses, else 0."""
    auxs = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    acfg = attn_cfg_for(cfg, None, prefix_len)
    if cfg.family in ("ssm", "hybrid"):
        (layers,), (x,) = layers, xs
        if cfg.family == "ssm":
            for layer in layers:
                x, _ = _remat(layer, x)
        else:
            x0 = x
            for g in range(_groups(cfg)):
                x = _remat(_hybrid_group, layers, cfg, g, x, x0, acfg, positions)
        return [x], auxs
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg, prefix_len)
        for i in range(len(layers[0])):
            xs = _run_body([lay[i] for lay in layers], xs, a_loc, a_glo, positions, sp=sp)
        return xs, auxs
    for name, bodies in _block_groups(layers):
        for i in range(len(bodies[0])):
            out = _run_body([b[i] for b in bodies], xs, acfg, positions, sp=sp)
            if name == "moe_layers":
                xs, a = out
                auxs = [t + u for t, u in zip(auxs, a)]
            else:
                xs = out
    return xs, auxs


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


def rank_cache(layers: nn.Module, cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """A rank's decode cache: :func:`init_cache` with the KV heads its
    blocks hold (:func:`kv_heads`; all of them at M = 1)."""
    block = next((m for m in layers.modules() if isinstance(m, (DenseBlock, MoEBlock))),
                 None)
    if block is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv_heads(block))
    return init_cache(cfg, batch, max_len, dtype, device)


def _layer_cache(group: dict, i: int) -> dict:
    """Layer ``i``'s entries (views) of one stacked group of the cache."""
    return {name: leaf[i] for name, leaf in group.items()}


def _stacked(states: list[dict]) -> dict:
    """Per-layer state dicts stacked on a new leading axis."""
    return {name: torch.stack([st[name] for st in states]) for name in states[0]}


def stack_prefill(layers: list, xs: list, cfg: ModelConfig, positions,
                  max_len: int, cache_dtype=torch.bfloat16, prefix_len: int = 0,
                  sp: bool = False):
    """Forward over the prompt of each rank (``layers``/``xs``/``sp`` as
    :func:`stack_forward`'s), returning (xs, each rank's decode cache at
    ``max_len``): k/v in ``cache_dtype``, the rank's KV heads
    (:func:`rank_cache`); rwkv6's and Mamba2's states as their layers
    leave them (float32 recurrent states, the token-shift carries and the
    conv inputs in the compute dtype), as the reference's prefill does."""
    acfg = attn_cfg_for(cfg, None, prefix_len)
    if cfg.family == "ssm":
        (layers,), (x,) = layers, xs
        states = []
        for layer in layers:
            x, st = layer(x)
            states.append(st)
        return [x], [_stacked(states)]
    if cfg.family == "hybrid":
        (layers,), (x,) = layers, xs
        x0, states = x, []
        cache = {"attn_kv": init_cache(cfg, x.shape[0], max_len, cache_dtype,
                                       x.device)["attn_kv"]}
        for g, lora in enumerate(layers["lora"]):
            for i in _group_layers(cfg, g):
                x, st = layers["mamba"][i](x, "final")
                states.append(st)
            x = layers["shared"].prefill(x, x0, lora, acfg, positions,
                                         _layer_cache(cache["attn_kv"], g))
        return [x], [{**_stacked(states), **cache}]
    b, s = xs[0].shape[0], positions.shape[1]
    caches = [rank_cache(lay, cfg, b, max_len, cache_dtype, x.device)
              for lay, x in zip(layers, xs)]
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg, prefix_len)
        for i in range(len(layers[0])):
            pairs = [lay[i] for lay in layers]
            with unsharded(*pairs):
                # the local layer's k/v at full length, folded into its ring
                locs = [p["local"] for p in pairs]
                fulls = [init_kv_cache(b, s, dataclasses.replace(
                    a_loc, n_kv_heads=c["local"]["k"].shape[3]), cache_dtype, x.device)
                    for c, x in zip(caches, xs)]
                xs = dense_block(locs, xs, _attend_fn(locs, a_loc, positions, sp, fulls), sp)
                for c, full in zip(caches, fulls):
                    ring = _ring_from_full(full, s, _local_len(cfg, max_len))
                    for name in ("k", "v"):
                        c["local"][name][i] = ring[name]
                glos = [p["global"] for p in pairs]
                views = [_layer_cache(c["global"], i) for c in caches]
                xs = dense_block(glos, xs, _attend_fn(glos, a_glo, positions, sp, views), sp)
        return xs, caches
    for name, bodies in _block_groups(layers):
        for i in range(len(bodies[0])):
            blocks = [bl[i] for bl in bodies]
            views = [_layer_cache(c[name], i) for c in caches]
            with unsharded(*blocks):
                out = _block(blocks, xs, _attend_fn(blocks, acfg, positions, sp, views), sp)
            xs = out[0] if isinstance(blocks[0], MoEBlock) else out
    return xs, caches


def _write(cache: dict, i: int, state: dict) -> None:
    """Layer ``i``'s new state into the stacked cache, in its dtypes."""
    for name, value in state.items():
        cache[name][i] = value


def stack_decode(layers: list, xs: list, caches: list, index: int, cfg: ModelConfig):
    """One-token decode through each rank's stack (``layers``/``xs``/
    ``caches``: one a rank), the stream whole on every rank.  xs: (B, 1,
    D); the caches are updated in place and returned.  The recurrent
    states ignore ``index``."""
    acfg = attn_cfg_for(cfg, None)
    if cfg.family == "ssm":
        (layers,), (x,), (cache,) = layers, xs, caches
        for i, layer in enumerate(layers):
            x, st = layer(x, _layer_cache(cache, i))
            _write(cache, i, st)
        return [x], caches
    if cfg.family == "hybrid":
        (layers,), (x,), (cache,) = layers, xs, caches
        x0 = x
        for g, lora in enumerate(layers["lora"]):
            for i in _group_layers(cfg, g):
                x, st = layers["mamba"][i](x, {"ssm": cache["ssm"][i],
                                               "conv": cache["conv"][i]})
                _write(cache, i, st)
            x = layers["shared"].decode(x, x0, lora, _layer_cache(cache["attn_kv"], g),
                                        index, acfg)
        return [x], caches
    if cfg.layer_pattern == "local_global":
        a_loc, a_glo = _pair_cfgs(cfg)
        for i in range(len(layers[0])):
            pairs = [lay[i] for lay in layers]
            with unsharded(*pairs):
                for part, a, ring in (("local", a_loc, True), ("global", a_glo, False)):
                    blocks = [p[part] for p in pairs]
                    views = [_layer_cache(c[part], i) for c in caches]
                    xs = dense_block(blocks, xs, _decode_fn(blocks, views, index, a, ring),
                                     False)
        return xs, caches
    for name, bodies in _block_groups(layers):
        for i in range(len(bodies[0])):
            blocks = [bl[i] for bl in bodies]
            views = [_layer_cache(c[name], i) for c in caches]
            with unsharded(*blocks):
                out = _block(blocks, xs, _decode_fn(blocks, views, index, acfg), False)
            xs = out[0] if isinstance(blocks[0], MoEBlock) else out
    return xs, caches
