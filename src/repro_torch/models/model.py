"""CausalLM — the model API of the trainer and the server (the
reference's ``repro.models.model.CausalLM`` for the dense, vlm, audio,
moe, ssm and hybrid families).

    model = CausalLM(cfg)                        # on the card; seed 0
    logits, aux = model.forward(tokens)          # (B, S) -> (B, S, V) f32;
                                                 # aux: the MoE layers' loss
    loss, metrics = model.loss(tokens, labels)   # mean CE (+ aux)
    logits, cache = model.prefill(tokens, max_len)       # last-token logits
    logits, cache = model.decode_step(tokens, cache, index)

A vlm (paligemma) takes an optional ``prefix_embeds`` (B, P, D) in
forward and prefill, concatenated before the token embeddings (the
reference's stub of the image tower); its first ``cfg.prefix_tokens``
positions attend bidirectionally, whether they hold that prefix or
tokens.  The audio family (musicgen) takes (B, S, K) codebook tokens (the
reference's stub of the EnCodec encoder): ``embed`` is (K, V, D), the K
lookups are summed, and the logits are (B, S, K, V).

The reference keeps its parameters in a plain pytree beside a stateless
class; here the module owns them, in ``cfg.param_dtype``, and reads them
in the compute dtype ``cfg.dtype`` (see ``CastParams``).  ``forward`` and
``loss`` record gradients where autograd is on, for every family; each
scanned body of the reference (a layer, a local/global pair, a zamba2
group) then runs under ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` wraps it.  ``prefill`` and ``decode_step`` never
record.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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
    (``repro_torch.convert``).  Parameters carry gradients; a server
    freezes them with ``requires_grad_(False)``."""

    LOSS_CHUNK = 512

    def __init__(self, cfg: ModelConfig, device=None, seed: int | None = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        kw = dict(device=self.device, dtype=torch_dtype(cfg.param_dtype))
        d = cfg.d_model
        audio = cfg.family == "audio"
        k = cfg.num_codebooks
        self.embed = (empty_param(k, cfg.vocab_size, d, **kw) if audio
                      else empty_param(cfg.vocab_size, d, **kw))
        self.layers = init_stack(cfg, **kw)
        self.final_norm = empty_param(d, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = empty_param(d, cfg.vocab_size * (k if audio else 1), **kw)
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
        param_init(self.embed, gen)      # audio: the K tables in codebook order
        reset_stack(self.layers, gen)
        self.final_norm.fill_(0.0 if self.cfg.post_norms else 1.0)
        if not self.cfg.tie_embeddings:
            param_init(self.lm_head, gen)

    # ----------------------------------------------------------------- embed
    def _embed(self, tokens: torch.Tensor, prefix_embeds=None) -> torch.Tensor:
        if self.cfg.family == "audio":
            # (B, S, K): the K codebook lookups summed in the compute dtype,
            # in codebook order
            if tokens.dim() != 3 or tokens.shape[-1] != self.cfg.num_codebooks:
                raise ValueError(f"{self.cfg.name} takes (B, S, "
                                 f"{self.cfg.num_codebooks}) tokens, got "
                                 f"{tuple(tokens.shape)}")
            x = torch.zeros(tokens.shape[:2] + (self.cfg.d_model,), dtype=self.dtype,
                            device=self.device)
            for kb in range(self.cfg.num_codebooks):
                x = x + self.embed[kb][tokens[..., kb]].to(self.dtype)
        else:
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
        """(B, S, D) -> float32 logits (B, S, V), or (B, S, K, V) for audio."""
        dt = x.dtype
        audio = self.cfg.family == "audio"
        if self.cfg.tie_embeddings:
            table = self.cast("embed", dt)
            logits = (torch.einsum("bsd,kvd->bskv", x, table) if audio
                      else x @ table.T)
        else:
            logits = x @ self.cast("lm_head", dt)
            if audio:
                logits = logits.reshape(x.shape[:2] + (self.cfg.num_codebooks,
                                                       self.cfg.vocab_size))
        logits = logits.float()
        if self.cfg.final_softcap is not None:
            cap = self.cfg.final_softcap
            logits = cap * torch.tanh(logits / cap)
        return logits

    def _final_norm(self, x):
        return rms_norm(x, self.final_norm, self.cfg.norm_eps,
                        plus_one=self.cfg.post_norms)

    # --------------------------------------------------------------- forward
    def forward_hidden(self, tokens: torch.Tensor, prefix_embeds=None):
        """The stack's normed output before unembedding: (x (B, S, D),
        aux)."""
        x = self._embed(tokens.to(self.device), prefix_embeds)
        x, aux = stack_forward(self.layers, x, self.cfg, self._positions(x),
                               self._prefix_len())
        return self._final_norm(x), aux

    def forward(self, tokens: torch.Tensor, prefix_embeds=None):
        """Full forward over (B, S) tokens ((B, S, K) for audio; after
        ``prefix_embeds``, a vlm's).  Returns (logits, aux_loss)."""
        x, aux = self.forward_hidden(tokens, prefix_embeds)
        return self._unembed(x), aux

    def _chunk_loss(self, x: torch.Tensor, labels: torch.Tensor):
        """(sum of the chunk's nll over labels >= 0, their count)."""
        logits = self._unembed(x)                      # (B, C[, K], V) f32
        lw = (labels >= 0).float()
        lp = torch.log_softmax(logits, dim=-1)
        nll = -lp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        return (nll * lw).sum(), lw.sum()

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, prefix_embeds=None):
        """Mean next-token cross entropy over labels >= 0 (+ the MoE aux).
        Returns (loss, {"ce", "aux"}).

        As the reference's, the (B, S, V) float32 logits never exist at
        once: the cross entropy runs over sequence chunks of at most
        ``LOSS_CHUNK`` (a divisor of S), each under
        ``torch.utils.checkpoint`` where autograd records, so the backward
        holds one chunk's logits at a time."""
        check_supported(self.cfg)
        x, aux = self.forward_hidden(tokens, prefix_embeds)
        labels = labels.to(self.device).long()
        if self.cfg.family == "vlm":
            x = x[:, self.cfg.prefix_tokens:]          # labels cover text only
        s = x.shape[1]
        chunk = min(self.LOSS_CHUNK, s)
        while s % chunk:
            chunk -= 1
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        for c0 in range(0, s, chunk):
            args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            t, c = (checkpoint(self._chunk_loss, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else self._chunk_loss(*args))
            tot, cnt = tot + t, cnt + c
        ce = tot / cnt.clamp(min=1.0)
        return ce + aux.float(), {"ce": ce, "aux": aux}

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
        """One serve step.  tokens: (B, 1) ((B, 1, K) for audio);
        ``index``: the position every row decodes at.  Returns (logits
        (B, 1, V) ((B, 1, K, V)), cache updated in place)."""
        tokens = tokens.to(self.device)
        x, cache = stack_decode(self.layers, self._embed(tokens), cache,
                                int(index), self.cfg)
        return self._unembed(self._final_norm(x)), cache

    # ------------------------------------------------------------- reporting
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
