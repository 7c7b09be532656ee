"""Architecture registry.

``get_config(name)`` returns the FULL published config (what the card runs:
one card, or a (data, model) mesh of ranks, ``repro_torch.dist.zero``);
``get_smoke(name)`` a reduced same-family config for CPU tests.  The ten
config modules are pure data, copied from the reference's
``repro.configs``; the tests hold both equal field by field.

The dry-run's grid (``repro_torch.launch.dryrun``), as the reference's:
``SHAPES`` (seq_len x global_batch of each kind), ``cells()`` (every arch x
shape; ``long_500k`` only for the sub-quadratic ``LONG_CONTEXT_ARCHS``),
``input_specs(cfg, shape)`` (meta tensors of every model input of a cell:
nothing allocated) and ``param_stats(cfg)`` (exact total and active
parameters, from a model on the meta device).

Shape grid (LM family — seq_len x global_batch):
    train_4k     4,096 x 256   training        -> train step
    prefill_32k 32,768 x  32   inference       -> prefill
    decode_32k  32,768 x 128   one new token   -> decode step
    long_500k  524,288 x   1   one new token   -> decode step (sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCHS = (
    "starcoder2-3b",
    "chatglm3-6b",
    "qwen1.5-32b",
    "gemma2-2b",
    "paligemma-3b",
    "musicgen-large",
    "rwkv6-3b",
    "deepseek-moe-16b",
    "moonshot-v1-16b-a3b",
    "zamba2-2.7b",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic attention: the SSM (rwkv6), the hybrid
# (zamba2) and gemma2 (half its layers windowed); full-attention archs skip it
LONG_CONTEXT_ARCHS = ("rwkv6-3b", "zamba2-2.7b", "gemma2-2b")


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def cells(include_skipped: bool = False) -> list[tuple[str, str]]:
    """All (arch, shape) cells; the skipped long_500k cells only with
    ``include_skipped``."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors of every model input of one cell, in the reference's
    shapes and dtypes: train {tokens, labels[, prefix_embeds]}, prefill
    {tokens[, prefix_embeds]}, decode {tokens} (one new token; the cache
    comes from ``init_cache``)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    # a vlm's prefix embeddings come from the stub vision tower; text fills the rest
    s_text = s - cfg.prefix_tokens if cfg.family == "vlm" else s
    if shape.kind == "decode":
        return {"tokens": meta((b, 1) + k)}
    out = {"tokens": meta((b, s_text) + k)}
    if shape.kind == "train":
        out["labels"] = meta((b, s_text) + k)
    if cfg.family == "vlm":
        out["prefix_embeds"] = meta((b, cfg.prefix_tokens, cfg.d_model), torch.bfloat16)
    return out


_STATS: dict = {}


def param_stats(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameters, exact, from a model on the meta device.
    Active counts the parameters a token's forward reads, each as often as
    it runs: a MoE's routed experts count top_k / n_experts; zamba2's
    shared block counts once per group (reuse makes active > total for the
    hybrid, as 6 N D wants)."""
    if cfg in _STATS:
        return _STATS[cfg]
    from repro_torch.models.model import CausalLM

    model = CausalLM(cfg, device="meta", seed=None)

    def size(module) -> int:
        return sum(p.numel() for p in module.parameters())

    total = active = size(model)
    if cfg.family == "moe":
        routed = sum(size(block.moe.experts) for block in model.layers["moe_layers"])
        active = int(total - routed * (1 - cfg.moe.top_k / cfg.moe.n_experts))
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        active = int(total + (groups - 1) * size(model.layers["shared"]))
    _STATS[cfg] = (total, active)
    return total, active


__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "SHAPES", "ShapeSpec", "cells", "get_config",
           "get_smoke", "input_specs", "param_stats"]
