"""Architecture registry.

``get_config(name)`` returns the FULL published config; ``get_smoke(name)``
a reduced same-family config for CPU smoke tests.  The ten config modules
are pure data, copied from the reference's ``repro.configs``.  Its
``input_specs``/``param_stats`` (``jax.eval_shape`` helpers of the dry-run)
are not ported yet.
"""
from __future__ import annotations

import importlib

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


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCHS", "get_config", "get_smoke"]
