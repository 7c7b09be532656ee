"""CausalLM — the model API of the server (the reference's
``repro.models.model.CausalLM`` for the dense, vlm, moe, ssm and hybrid
families; the audio family is not ported).

    model = CausalLM(cfg)                        # on the card; seed 0
    logits, aux = model.forward(tokens)          # (B, S) -> (B, S, V) f32;
                                                 # aux: the MoE layers' loss
    logits, cache = model.prefill(tokens, max_len)       # last-token logits
    logits, cache = model.decode_step(tokens, cache, index)

A vlm (paligemma) takes an optional ``prefix_embeds`` (B, P, D) in
forward and prefill, concatenated before the token embeddings (the
reference's stub of the image tower); its first ``cfg.prefix_tokens``
positions attend bidirectionally, whether they hold that prefix or
tokens.

The reference keeps its parameters in a plain pytree beside a stateless
class; here the module owns them, in ``cfg.param_dtype``, and reads them
in the compute dtype ``cfg.dtype`` (a cached copy, see ``CastParams``).
Inference only: the parameters need no gradient.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .config import ModelConfig
from .layers import CastParams, empty_param, param_init, rms_norm
from .transformer import (
    check_supported,
    init_cache,
    init_stack,
    reset_stack,
    stack_decode,
    stack_forward,
    stack_prefill,
)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class CausalLM(CastParams):
    """``device=None`` means the card (raises without CUDA); ``seed=None``
    leaves the parameters uninitialised, for a caller that loads them
    (``repro_torch.convert``)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int | None = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        kw = dict(device=self.device, dtype=torch_dtype(cfg.param_dtype))
        d = cfg.d_model
        self.embed = empty_param(cfg.vocab_size, d, **kw)
        self.layers = init_stack(cfg, **kw)
        self.final_norm = empty_param(d, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = empty_param(d, cfg.vocab_size, **kw)
        if seed is not None:
            self.init(seed)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int) -> None:
        """The port's own weights, drawn on the model's device from a
        ``torch.Generator`` seeded with ``seed``: normal x 0.02 (``wo`` x
        0.02/sqrt(2)), biases 0, norms 1 (0 with ``post_norms``).  The
        shapes and scales are the reference's; the draws are not."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        param_init(self.embed, gen)
        reset_stack(self.layers, gen)
        self.final_norm.fill_(0.0 if self.cfg.post_norms else 1.0)
        if not self.cfg.tie_embeddings:
            param_init(self.lm_head, gen)

    # ----------------------------------------------------------------- embed
    def _embed(self, tokens: torch.Tensor, prefix_embeds=None) -> torch.Tensor:
        x = self.embed[tokens].to(self.dtype)
        if prefix_embeds is not None:
            if self.cfg.family != "vlm":
                raise ValueError(f"{self.cfg.name} takes no prefix_embeds "
                                 "(only the vlm family has a prefix)")
            x = torch.cat([prefix_embeds.to(self.device, self.dtype), x], dim=1)
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype).item()
        return x

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        b, s = x.shape[:2]
        return torch.arange(s, device=x.device).expand(b, s)

    def _prefix_len(self) -> int:
        return self.cfg.prefix_tokens if self.cfg.family == "vlm" else 0

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.cfg.tie_embeddings:
            logits = x @ self.cast("embed", dt).T
        else:
            logits = x @ self.cast("lm_head", dt)
        logits = logits.float()
        if self.cfg.final_softcap is not None:
            cap = self.cfg.final_softcap
            logits = cap * torch.tanh(logits / cap)
        return logits

    def _final_norm(self, x):
        return rms_norm(x, self.final_norm, self.cfg.norm_eps,
                        plus_one=self.cfg.post_norms)

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, prefix_embeds=None):
        """Full forward over (B, S) tokens (after ``prefix_embeds``, a
        vlm's).  Returns (logits, aux_loss)."""
        x = self._embed(tokens.to(self.device), prefix_embeds)
        x, aux = stack_forward(self.layers, x, self.cfg, self._positions(x),
                               self._prefix_len())
        return self._unembed(self._final_norm(x)), aux

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        return init_cache(self.cfg, batch, max_len, dtype, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                cache_dtype=torch.bfloat16, prefix_embeds=None):
        """Prompt forward + cache build.  Returns (last-token logits
        (B, 1, V), cache)."""
        x = self._embed(tokens.to(self.device), prefix_embeds)
        x, cache = stack_prefill(self.layers, x, self.cfg, self._positions(x),
                                 max_len, cache_dtype, self._prefix_len())
        return self._unembed(self._final_norm(x[:, -1:])), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, index: int):
        """One serve step.  tokens: (B, 1); ``index``: the position every
        row decodes at.  Returns (logits (B, 1, V), cache updated in
        place)."""
        tokens = tokens.to(self.device)
        x, cache = stack_decode(self.layers, self._embed(tokens), cache,
                                int(index), self.cfg)
        return self._unembed(self._final_norm(x)), cache

    # ------------------------------------------------------------- reporting
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
