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
"""
from __future__ import annotations

import torch

from ..models.model import CausalLM
from ..optim.adamw import AdamWConfig, apply_updates


def _loss(model: CausalLM, batch: dict):
    put = lambda x: torch.as_tensor(x, device=model.device)
    prefix = batch.get("prefix_embeds")
    return model.loss(put(batch["tokens"]).long(), put(batch["labels"]),
                      prefix_embeds=None if prefix is None else put(prefix))


def make_train_step(model: CausalLM, opt_cfg: AdamWConfig,
                    microbatches: int = 1, compressor=None):
    """compressor: optional ``repro_torch.dist.compress.Compressor``
    applied to the grads (quantise -> dequantise, stateless) before the
    update."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}

    def grads_of(batch):
        """Backward of one batch: (loss, metrics, {name: grad})."""
        for p in params.values():
            p.grad = None
        loss, metrics = _loss(model, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(opt_state: dict, batch: dict, step):
        if microbatches == 1:
            loss, metrics, grads = grads_of(batch)
        else:
            # split the global batch into microbatches; the grads are
            # summed in float32 and the metrics are the last microbatch's
            n = len(batch["tokens"])
            mb = n // microbatches
            gsum = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for name, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, metrics, g = grads_of(part)
                for name in gsum:
                    gsum[name] += g[name]
                loss = loss + l
            grads = {name: g / microbatches for name, g in gsum.items()}
            loss = loss / microbatches
        if compressor is not None:
            grads = compressor.roundtrip(grads)
        _, opt_state, opt_metrics = apply_updates(params, opt_state, grads, opt_cfg, step)
        return opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(model: CausalLM):
    def eval_step(batch: dict):
        with torch.no_grad():
            loss, metrics = _loss(model, batch)
        return {"loss": loss, **metrics}

    return eval_step


__all__ = ["make_eval_step", "make_train_step"]
