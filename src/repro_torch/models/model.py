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

Each method is its ``*_ranks`` function over the one rank of this model
(``self.tp``; ``SOLO`` when unsharded).  Those functions take one model a
rank of a data row that this process runs (``repro_torch.dist.tp``): a
model across M "model" ranks embeds vocab-parallel (ids outside the
rank's rows give zeros, then a sum over "model"), keeps each rank's
sequence shard between layers in train and prefill, gives logits over
the rank's vocabulary rows (the reference's ``("batch", None,
"vocab")``), takes the cross entropy's maximum and log-sum-exp over
"model", and gathers the vocabulary where a served token is chosen.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist.comm import SOLO, ScaleGrad, gather_seq, reduce_seq
from .config import ModelConfig
from .layers import CastParams, empty_param, param_init, rms_norm
from .transformer import (
    check_supported,
    init_stack,
    rank_cache,
    reset_stack,
    stack_decode,
    stack_forward,
    stack_prefill,
    unsharded,
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
        self.placement = None      # across ranks: repro_torch.dist.zero.ranked_lm
        self.tp = SOLO             # over "model": its repro_torch.dist.comm.Rank
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
    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` in the compute dtype.  Audio:
        (B, S, K) codebook tokens, the K lookups summed in codebook order.
        Where the table is split over "model" (this rank's rows), ids
        outside its rows give zeros."""
        if self.cfg.family == "audio":
            if tokens.dim() != 3 or tokens.shape[-1] != self.cfg.num_codebooks:
                raise ValueError(f"{self.cfg.name} takes (B, S, "
                                 f"{self.cfg.num_codebooks}) tokens, got "
                                 f"{tuple(tokens.shape)}")
            x = torch.zeros(tokens.shape[:2] + (self.cfg.d_model,), dtype=self.dtype,
                            device=self.device)
            for kb in range(self.cfg.num_codebooks):
                x = x + self.embed[kb][tokens[..., kb]].to(self.dtype)
            return x
        if "embed" not in getattr(self, "tp_split", ()):
            return self.embed[tokens].to(self.dtype)
        rows = self.embed.shape[0]
        ids = tokens - self.tp.m * rows
        ok = ((ids >= 0) & (ids < rows)).to(self.dtype)[..., None]
        return self.embed[ids.clamp(0, rows - 1)].to(self.dtype) * ok

    def _prefix_len(self) -> int:
        return self.cfg.prefix_tokens if self.cfg.family == "vlm" else 0

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> float32 logits (B, S, V) over the rank's vocabulary
        rows (all of them where the vocabulary does not split), or (B, S,
        K, V) for audio; the final softcap applied (elementwise)."""
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

    def _vocab_split(self) -> bool:
        head = "embed" if self.cfg.tie_embeddings else "lm_head"
        return head in getattr(self, "tp_split", ())

    # --------------------------------------------------------------- forward
    def forward_hidden(self, tokens: torch.Tensor, prefix_embeds=None):
        """The stack's normed output before unembedding: (x (B, S, D), its
        sequence shard across "model" ranks; aux)."""
        xs, auxs, _ = forward_hidden_ranks([self], [tokens], prefix_embeds)
        return xs[0], auxs[0]

    def forward(self, tokens: torch.Tensor, prefix_embeds=None):
        """Full forward over (B, S) tokens ((B, S, K) for audio; after
        ``prefix_embeds``, a vlm's).  Returns (logits, aux_loss).  Across
        "model" ranks the logits are the rank's vocabulary rows, (B, S,
        V/M), as the reference shards them."""
        logits, auxs = forward_ranks([self], [tokens], prefix_embeds)
        return logits[0], auxs[0]

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, prefix_embeds=None):
        """Mean next-token cross entropy over labels >= 0 (+ the MoE aux).
        Returns (loss, {"ce", "aux"}) (:func:`loss_ranks`)."""
        check_supported(self.cfg)
        return loss_ranks([self], [tokens], [labels], prefix_embeds)[0]

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """The decode cache of this rank: its KV heads, or all of them
        where they do not split over "model" (``cache_specs``)."""
        return rank_cache(self.layers, self.cfg, batch, max_len, dtype, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                cache_dtype=torch.bfloat16, prefix_embeds=None):
        """Prompt forward + cache build.  Returns (last-token logits
        (B, 1, V), cache); across "model" ranks every rank gets the whole
        vocabulary's logits and its own cache."""
        logits, caches = prefill_ranks([self], [tokens], max_len, cache_dtype, prefix_embeds)
        return logits[0], caches[0]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, index: int):
        """One serve step.  tokens: (B, 1) ((B, 1, K) for audio);
        ``index``: the position every row decodes at.  Returns (logits
        (B, 1, V) ((B, 1, K, V)), cache updated in place)."""
        logits, caches = decode_ranks([self], [tokens], [cache], int(index))
        return logits[0], caches[0]

    # ------------------------------------------------------------- reporting
    def param_count(self) -> int:
        """The model's parameters (across ranks: the whole model's)."""
        if self.placement is not None:
            return sum(math.prod(shape) for shape in self.placement.shapes.values())
        return sum(p.numel() for p in self.parameters())


# --------------------------------------------------------------------------
# the passes, over the models of the ranks of a data row in this process
# --------------------------------------------------------------------------
def _seq_len(tokens: list, prefix_embeds) -> int:
    return tokens[0].shape[1] + (0 if prefix_embeds is None else prefix_embeds.shape[1])


def _positions(x: torch.Tensor, s: int) -> torch.Tensor:
    """Positions 0..s-1 of the whole sequence, for each row of ``x``."""
    return torch.arange(s, device=x.device).expand(x.shape[0], s)


def embed_ranks(models: list, tokens: list, sp: bool, prefix_embeds=None) -> list:
    """Each rank's stream after the embedding: vocab-parallel where the
    table splits over "model" (each rank's lookup, then a sum over "model",
    reduce-scattered onto the sequence shards with ``sp``), else the
    lookup cut to the rank's sequence shard with ``sp``; a vlm's
    ``prefix_embeds`` before the tokens; gemma's sqrt(d) scale."""
    m0 = models[0]
    r0 = m0.tp
    xs = [m._lookup(t.to(m.device)) for m, t in zip(models, tokens)]
    if prefix_embeds is not None:
        if m0.cfg.family != "vlm":
            raise ValueError(f"{m0.cfg.name} takes no prefix_embeds "
                             "(only the vlm family has a prefix)")
        xs = [torch.cat([prefix_embeds.to(m.device, m.dtype), x], dim=1)
              for m, x in zip(models, xs)]
    if "embed" in getattr(m0, "tp_split", ()):
        xs = reduce_seq(r0.comm, xs, sp)
    elif sp and r0.M > 1:                  # the row's rows: cut the sequence
        from ..dist.sharding import shard

        xs = [shard(x, None, "seq_act", None, rules=m.tp.rules, coords={"model": m.tp.m})
              for m, x in zip(models, xs)]
    if m0.cfg.embed_scale:
        scale = torch.tensor(m0.cfg.d_model ** 0.5, dtype=m0.dtype).item()
        xs = [x * scale for x in xs]
    return xs


def forward_hidden_ranks(models: list, tokens: list, prefix_embeds=None):
    """The stack's normed output of each rank (its sequence shard where the
    sequence splits over "model"), the aux losses, and whether it split."""
    m0 = models[0]
    s = _seq_len(tokens, prefix_embeds)
    sp = s % m0.tp.M == 0
    xs = embed_ranks(models, tokens, sp, prefix_embeds)
    xs, auxs = stack_forward([m.layers for m in models], xs, m0.cfg, _positions(xs[0], s),
                             m0._prefix_len(), sp)
    return [m._final_norm(x) for m, x in zip(models, xs)], auxs, sp


def forward_ranks(models: list, tokens: list, prefix_embeds=None):
    """Each rank's logits over the whole sequence and its vocabulary rows,
    float32, and its aux loss."""
    xs, auxs, sp = forward_hidden_ranks(models, tokens, prefix_embeds)
    xs = gather_seq(models[0].tp.comm, xs, sp)
    return [m._unembed(x) for m, x in zip(models, xs)], auxs


def _chunk_ce(models: list, xs: list, labels: list) -> list:
    """(sum of the chunk's nll over labels >= 0, their count), a rank
    each; vocab-parallel where the head splits over "model"."""
    comm = models[0].tp.comm
    lg = [m._unembed(x) for m, x in zip(models, xs)]          # (B, C[, K], V) f32
    if not models[0]._vocab_split():
        lps = [torch.log_softmax(t, dim=-1) for t in lg]
        nlls = [-lp.gather(-1, y.clamp(min=0)[..., None])[..., 0] for lp, y in zip(lps, labels)]
    else:
        mx = comm.max([t.amax(-1) for t in lg])
        se = comm.sum([torch.exp(t - m[..., None]).sum(-1) for t, m in zip(lg, mx)])
        picks = []
        for model, t, y in zip(models, lg, labels):
            rows = t.shape[-1]
            ids = y - model.tp.m * rows
            ok = (ids >= 0) & (ids < rows)
            got = t.gather(-1, ids.clamp(0, rows - 1)[..., None])[..., 0]
            picks.append(torch.where(ok, got, torch.zeros_like(got)))
        nlls = [torch.log(s) + m - g for s, m, g in zip(se, mx, comm.sum(picks))]
    out = []
    for nll, y in zip(nlls, labels):
        lw = (y >= 0).float()
        out.append(((nll * lw).sum(), lw.sum()))
    return out


def loss_ranks(models: list, tokens: list, labels: list, prefix_embeds=None) -> list:
    """Each rank's (loss, {"ce", "aux"}): the mean next-token cross entropy
    over labels >= 0 of the global batch (the sums and counts of every rank
    of the comm averaged, ``all_mean``) + the MoE aux.

    As the reference's, the (B, S, V) float32 logits never exist at once:
    the cross entropy runs over sequence chunks of at most ``LOSS_CHUNK``
    (a divisor of S), each under ``torch.utils.checkpoint`` where autograd
    records, so the backward holds one chunk's logits at a time.  Across
    M "model" ranks the gradient carries 1/M, so that the M copies of a
    data row's loss count once."""
    m0 = models[0]
    xs, auxs, sp = forward_hidden_ranks(models, tokens, prefix_embeds)
    comm = m0.tp.comm
    xs = gather_seq(comm, xs, sp)
    if m0.cfg.family == "vlm":
        xs = [x[:, m0.cfg.prefix_tokens:] for x in xs]     # labels cover text only
    labels = [y.to(m.device).long() for m, y in zip(models, labels)]
    s = xs[0].shape[1]
    chunk = min(type(m0).LOSS_CHUNK, s)
    while s % chunk:
        chunk -= 1
    tot = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    cnt = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for c0 in range(0, s, chunk):
        args = (models, [x[:, c0:c0 + chunk] for x in xs], [y[:, c0:c0 + chunk] for y in labels])
        parts = (checkpoint(_chunk_ce, *args, use_reentrant=False)
                 if torch.is_grad_enabled() else _chunk_ce(*args))
        tot = [t + p[0] for t, p in zip(tot, parts)]
        cnt = [c + p[1] for c, p in zip(cnt, parts)]
    tot, cnt = comm.all_mean(tot), comm.all_mean(cnt)
    out = []
    for t, c, aux, model in zip(tot, cnt, auxs, models):
        ce = t / c.clamp(min=1.0)
        out.append((ScaleGrad.apply(ce + aux.float(), 1.0 / model.tp.M),
                    {"ce": ce, "aux": aux}))
    return out


def _full_logits(models: list, xs: list) -> list:
    """Each rank's last-position stream -> logits over the whole vocabulary
    (gathered over "model"), so every rank samples the same token."""
    lg = [m._unembed(m._final_norm(x)) for m, x in zip(models, xs)]
    return models[0].tp.comm.gather(lg, -1) if models[0]._vocab_split() else lg


def prefill_ranks(models: list, tokens: list, max_len: int, cache_dtype=torch.bfloat16,
                  prefix_embeds=None):
    """Prompt forward + cache build: (last-position logits (B, 1, V) on
    every rank, each rank's cache)."""
    m0 = models[0]
    s = _seq_len(tokens, prefix_embeds)
    sp = s % m0.tp.M == 0
    with unsharded(*models):
        xs = embed_ranks(models, tokens, sp, prefix_embeds)
    xs, caches = stack_prefill([m.layers for m in models], xs, m0.cfg, _positions(xs[0], s),
                               max_len, cache_dtype, m0._prefix_len(), sp)
    # the last position is on rank M-1 of a split sequence
    last = [t[:, -1:] for t in gather_seq(m0.tp.comm, [x[:, -1:] for x in xs], sp)]
    with unsharded(*models):
        return _full_logits(models, last), caches


def decode_ranks(models: list, tokens: list, caches: list, index: int):
    """One serve step over each rank's cache (updated in place), the
    stream whole on every rank: (logits (B, 1, V) on every rank, caches)."""
    with unsharded(*models):
        xs = embed_ranks(models, tokens, False)
    xs, caches = stack_decode([m.layers for m in models], xs, caches, int(index),
                              models[0].cfg)
    with unsharded(*models):
        return _full_logits(models, xs), caches
