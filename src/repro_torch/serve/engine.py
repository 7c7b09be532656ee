"""Batched serving: prefill + decode loop with a fixed-slot batch
(the reference's ``repro.serve.engine``).

Requests are packed into FIXED slots: a free slot is refilled from the
queue at the next prefill opportunity, so the decode batch shape never
changes.  Prefill runs per slot at batch 1 and every leaf of its cache
(k/v groups, rwkv6's recurrent state and token-shift carries, zamba2's
ssm/conv states; every leaf stacked over layers on axis 0) is spliced
into the batch cache at the slot's index of axis 1, in the batch cache's
dtype.

All occupied slots decode in lockstep at one index, the largest position
among them (the reference's simple baseline, mirrored here and recorded as
fault F4 in ROADMAP.md §3): a slot whose prompt is shorter writes its next
token's k/v further along than its own position.  The recurrent states
take no index.

The engine times its two phases on the device it runs on: CUDA events on
the card, the host clock on the CPU (``phase_ms``, with ``tokens``), and
counts the launches of kernel K3 in each (``k3_launches``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels.flash import flash_attention
from repro_torch.models.model import CausalLM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def _leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a cache tree (nested dicts), in key order."""
    return [leaf for key in sorted(tree) for leaf in
            (_leaves(tree[key]) if isinstance(tree[key], dict) else [tree[key]])]


class _Phase:
    """Adds to the engine's ``phase_ms`` and ``k3_launches`` of one phase:
    the milliseconds spent in it, read once its result has been
    synchronised (sampling copies tokens to the host), and the launches of
    kernel K3 made inside it."""

    def __init__(self, engine: "ServeEngine", name: str):
        self.engine, self.name = engine, name
        self.cuda = engine.device.type == "cuda"

    def __enter__(self):
        self.launches = flash_attention.launches
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.stop = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.stop.record()
            self.stop.synchronize()
            ms = self.start.elapsed_time(self.stop)
        else:
            ms = (time.perf_counter() - self.t0) * 1e3
        self.engine.phase_ms[self.name] += ms
        self.engine.k3_launches[self.name] += flash_attention.launches - self.launches
        return False


class ServeEngine:
    def __init__(self, model: CausalLM, batch_slots: int, max_len: int,
                 cache_dtype=torch.float32, seed: int = 0):
        self.model = model
        self.device = model.device
        self.slots = batch_slots
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.cache = model.init_cache(batch_slots, max_len, cache_dtype)
        self.cache_dtype = cache_dtype
        self.active: list[Request | None] = [None] * batch_slots
        self.positions = np.zeros(batch_slots, dtype=np.int64)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.phase_ms = {"prefill": 0.0, "decode": 0.0}
        self.tokens = {"prefill": 0, "decode": 0}
        self.k3_launches = {"prefill": 0, "decode": 0}
        self.decode_steps = 0

    # ------------------------------------------------------------------ api
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        """Fill free slots: run prefill for queued requests and splice their
        caches into the batch cache at the slot index."""
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            plen = len(req.prompt)
            toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                   device=self.device)[None]
            with _Phase(self, "prefill"):
                logits, cache1 = self.model.prefill(toks, self.max_len,
                                                    self.cache_dtype)
                # splice every leaf of the one-sequence cache into the slot
                for full, one in zip(_leaves(self.cache), _leaves(cache1)):
                    full[:, slot] = one[:, 0]
                first = self._sample(logits[:, 0], [req.temperature])[0]
            self.tokens["prefill"] += plen
            req.out_tokens.append(int(first))
            self.active[slot] = req
            self.positions[slot] = plen

    def _sample(self, logits: torch.Tensor, temperatures) -> np.ndarray:
        """Per-slot sampling: greedy at temperature 0, else categorical
        over ``logits / T`` drawn from the engine's generator.

        logits: (B, V); temperatures: one per row."""
        temps = np.asarray(temperatures, np.float32).reshape(-1)
        greedy = logits.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy.cpu().numpy()
        t = torch.as_tensor(np.maximum(temps, 1e-6), device=logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        return np.where(temps > 0, sampled.cpu().numpy(), greedy.cpu().numpy())

    def step(self):
        """One decode step for all occupied slots."""
        self._admit()
        occupied = [i for i, r in enumerate(self.active) if r is not None]
        if not occupied:
            return False
        toks = np.zeros((self.slots, 1), dtype=np.int64)
        for i in occupied:
            toks[i, 0] = self.active[i].out_tokens[-1]
        idx = int(max(self.positions[i] for i in occupied))
        temps = [r.temperature if r else 0.0 for r in self.active]
        with _Phase(self, "decode"):
            logits, self.cache = self.model.decode_step(
                torch.as_tensor(toks, device=self.device), self.cache, idx)
            nxt = self._sample(logits[:, 0], temps)
        self.tokens["decode"] += len(occupied)
        self.decode_steps += 1
        for i in occupied:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i]))
            self.positions[i] += 1
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.active[i] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.finished
