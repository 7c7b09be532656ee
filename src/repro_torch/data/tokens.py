"""Synthetic, seeded, shardable token pipeline (a numpy copy of the
reference's ``repro.data.tokens``: its batches are byte-equal).

Deterministic function of (seed, step, shard): every host computes exactly
its slice of the global batch with numpy (no device transfer until the
trainer ships it), and restart-at-step-k reproduces the same stream — the
property checkpoint/restore tests rely on.

The stream is NOT uniform noise: tokens follow a mixture of
(a) an affine recurrence x_{t+1} = (a*x_t + b) mod V on a segment,
(b) segment resets with fresh (a, b) drawn per segment,
(c) occasional verbatim copies of an earlier window (induction heads).
A ~100M-param model measurably learns this in a few hundred steps, which
is what the reference's examples/train_lm.py demonstrates.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    segment_len: int = 64
    copy_prob: float = 0.25
    num_codebooks: int = 0      # >0 -> audio-style (B, S, K) tokens
    prefix_tokens: int = 0      # >0 -> vlm-style precomputed prefix embeds
    d_model: int = 0            # for prefix embeds


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def _sequence(rng: np.random.Generator, cfg: DataConfig, length: int) -> np.ndarray:
    """Per segment, one of three generators (most→least learnable):

    * tiled pattern (60 %): a short random motif (period 2–8) repeated —
      induction-head learnable within tens of steps;
    * verbatim copy of an earlier window (copy_prob);
    * affine recurrence x_{t+1} = (a x_t + b) mod V — the long-tail hard
      component (in-context modular regression).
    """
    v = cfg.vocab_size
    out = np.empty(length, dtype=np.int64)
    t = 0
    while t < length:
        seg = min(cfg.segment_len, length - t)
        u = rng.random()
        if t > cfg.segment_len and u < cfg.copy_prob:
            src = rng.integers(0, t - seg + 1) if t - seg + 1 > 0 else 0
            out[t : t + seg] = out[src : src + seg]
        elif u < cfg.copy_prob + 0.6:
            p = int(rng.integers(2, 9))
            motif = rng.integers(0, v, size=p)
            reps = -(-seg // p)
            out[t : t + seg] = np.tile(motif, reps)[:seg]
        else:
            a = int(rng.integers(1, 64)) * 2 + 1          # odd multiplier
            b = int(rng.integers(0, v))
            x = int(rng.integers(0, v))
            for i in range(seg):
                out[t + i] = x
                x = (a * x + b) % v
        t += seg
    return out


def shard_rows(global_batch: int, shard: int, num_shards: int,
               microbatches: int = 1) -> list[int]:
    """The global rows of ``shard`` of ``num_shards``, in order: its slice
    of each of ``microbatches`` contiguous microbatches in turn (the
    reference's step splits the global batch into microbatches first and
    shards each over the dp axes), so that the shard's microbatch i is
    its i-th contiguous part.  One microbatch: rows shard x B/num_shards
    onward."""
    assert global_batch % (num_shards * microbatches) == 0
    mb = global_batch // microbatches
    per = mb // num_shards
    return [i * mb + shard * per + j for i in range(microbatches) for j in range(per)]


def make_batch(cfg: DataConfig, step: int, shard: int = 0, num_shards: int = 1,
               microbatches: int = 1):
    """Global-batch slice for `shard` of `num_shards` at `step`: the rows
    of :func:`shard_rows` (with ``microbatches``, each microbatch's slice).

    Returns dict of numpy arrays: tokens/labels (+ prefix_embeds for vlm).
    Labels are next-token: labels[t] = tokens[t+1] (last label masked -1).
    """
    rows = shard_rows(cfg.global_batch, shard, num_shards, microbatches)
    b_local = len(rows)
    k = max(1, cfg.num_codebooks)
    s_text = cfg.seq_len - cfg.prefix_tokens
    toks = np.empty((b_local, s_text + 1, k), dtype=np.int64)
    for i, row in enumerate(rows):
        rng = _rng_for(cfg, step, row)
        for kb in range(k):
            toks[i, :, kb] = _sequence(rng, cfg, s_text + 1)
    tokens = toks[:, :-1]
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    if cfg.num_codebooks == 0:
        tokens, labels = tokens[..., 0], labels[..., 0]
    out = {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}
    if cfg.prefix_tokens:
        rng = _rng_for(cfg, step, 10_000_019 + shard)
        out["prefix_embeds"] = rng.standard_normal(
            (b_local, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


class TokenPipeline:
    """Stateful cursor wrapper used by the trainer (cursor = step index)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 microbatches: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.microbatches = microbatches
        self.step = 0

    def next(self):
        batch = make_batch(self.cfg, self.step, self.shard, self.num_shards,
                           self.microbatches)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
