"""train_step factory: loss + grads + AdamW, with optional microbatch
gradient accumulation and gradient compression (the reference's
``repro.train.step``).

The model owns its parameters, so the step takes and returns the optimizer
state only and updates the parameters in place:

    step_fn = make_train_step(model, AdamWConfig(...))
    opt_state, metrics = step_fn(opt_state, batch, step)

``batch`` holds ``tokens`` and ``labels`` ((B, S), or (B, S, K) for
audio) and, for a vlm, ``prefix_embeds``, as numpy arrays or tensors.
The metrics are 0-dim tensors: ``loss``, ``ce``, ``aux``, ``grad_norm``
and ``lr``.

A model across ranks (``repro_torch.dist.zero.ranked_lm``) takes its
data row's rows of the global batch (``data.tokens.TokenPipeline(shard=d,
num_shards=D, microbatches=n)`` for data coordinate d of D); its gradients
are the global batch's mean (FSDP's over "data", then ``Placement.sync_grads``), each rank
updates its own shards, the gradient norm counts each element once (a
leaf held whole by several ranks is divided by their count), and
``loss``, ``ce`` and ``aux`` are means over the ranks (the global batch's,
where every row has as many labels).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.model import CausalLM
from ..optim.adamw import AdamWConfig, _local, apply_updates


def _loss(model: CausalLM, batch: dict):
    put = lambda x: torch.as_tensor(x, device=model.device)
    prefix = batch.get("prefix_embeds")
    return model.loss(put(batch["tokens"]).long(), put(batch["labels"]),
                      prefix_embeds=None if prefix is None else put(prefix))


def make_train_step(model: CausalLM, opt_cfg: AdamWConfig,
                    microbatches: int = 1, compressor=None):
    """compressor: optional ``repro_torch.dist.compress.Compressor``
    applied to the grads (quantise -> dequantise, stateless) before the
    update.

    With ``microbatches``, the batch splits into that many contiguous
    parts, each a backward of its own (across ranks: each rank's part i is
    its slice of the global microbatch i, ``data.tokens.TokenPipeline(...,
    microbatches=n)``, and FSDP reduce-scatters each microbatch's
    gradients); the gradients are summed in float32 and divided by their
    count, the loss is the microbatches' mean and the other metrics are the
    last microbatch's, as the reference's.  The compressor acts on the
    global gradient with each reference leaf's statistic
    (``Compressor.leaf_stats``: a stacked group's over its layers, and
    across ranks over every rank's shards)."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    place = model.placement
    group = None if place is None else place.world.get_group()
    replicas = None if place is None else {n: place.replicas(n) for n in params}

    def grads_of(batch):
        """Backward of one batch: (loss, metrics, {name: grad})."""
        for p in params.values():
            p.grad = None
        loss, metrics = _loss(model, batch)
        loss.backward()
        if place is not None:
            place.sync_grads(params)
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        loss = loss.detach()
        if place is not None:              # means over the ranks
            for v in (loss, *metrics.values()):
                dist.all_reduce(v, group=group)
                v /= place.ranks
        return loss, metrics, grads

    def train_step(opt_state: dict, batch: dict, step):
        if microbatches == 1:
            loss, metrics, grads = grads_of(batch)
        else:
            # split the batch into microbatches; the grads are summed in
            # float32 and the metrics are the last microbatch's
            n = len(batch["tokens"])
            mb = n // microbatches
            gsum = None
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, metrics, g = grads_of(part)
                if gsum is None:
                    gsum = {name: torch.zeros_like(t, dtype=torch.float32)
                            for name, t in g.items()}
                for name in gsum:
                    gsum[name] += g[name]
                loss = loss + l
            grads = {name: g / microbatches for name, g in gsum.items()}
            loss = loss / microbatches
        if compressor is not None:
            stats = compressor.leaf_stats(grads, place)
            if place is not None:
                grads = {n: _local(g) for n, g in grads.items()}
            grads = compressor.roundtrip(grads, stats)
        _, opt_state, opt_metrics = apply_updates(params, opt_state, grads, opt_cfg, step,
                                                  group, replicas)
        return opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(model: CausalLM):
    def eval_step(batch: dict):
        with torch.no_grad():
            loss, metrics = _loss(model, batch)
        return {"loss": loss, **metrics}

    return eval_step


__all__ = ["make_eval_step", "make_train_step"]
