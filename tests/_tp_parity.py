"""Helpers of the tensor-parallel parity tests of the ssm, hybrid, vlm and
audio families (``tests/test_torch_tp_ssm.py``,
``tests/test_torch_tp_vlm_audio.py``): every rank of a (data D, model M)
mesh in one process (``LocalComm``), held in float32 to the port's
unsharded model and to the reference on the same parameters and batch.

* ``check_local_shapes``: each rank's leaves of the full config (meta
  device) are their shards under ``param_specs`` over "model".
* ``check_train``: the logits (joined over the data rows; the vocabulary
  too where they split), the loss with its ce and aux, and every gradient
  (summed over the ranks that hold the same slice) within 1e-5 relative of
  the unsharded port and of ``jax.value_and_grad`` of the reference, over
  several loss chunks with masked labels.  A vlm's ranks take the global
  batch's own ``prefix_embeds``, cut by rows.
* ``check_serving``: a prefill and three greedy decode steps, logits
  within 1e-5 of the unsharded port's, the same greedy tokens, and each
  rank's cache leaves shaped as ``cache_specs`` places them over the mesh
  (decode rules: the batch over "data", heads over "model").

The reference's runs are cached per (arch, config change), as
``tests/test_torch_sharding.py`` caches its specs.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _train_parity import batch, ref_leaf, rel
from repro.configs import get_smoke as r_get_smoke
from repro.models.model import CausalLM as RModel
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist import tp
from repro_torch.dist.comm import LocalComm
from repro_torch.dist.sharding import cache_specs, param_specs
from repro_torch.models.model import (CausalLM, decode_ranks, forward_ranks, loss_ranks,
                                      prefill_ranks)
from repro_torch.models.transformer import init_cache

B, CHUNK = 4, 8


def f32(cfg, **change):
    cfg = dataclasses.replace(cfg, dtype="float32", **change)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def draw_finite(params, seed=0):
    """zamba2's LoRA adapters drawn (the reference's init starts ``b`` at
    zeros, which leaves ``a``'s gradient 0) and its Mamba2 ``dt_bias`` in
    [-5, -4], where the reference's chunked SSD gradient is finite (F8,
    ``tests/test_torch_train_ssm.py``); other families as drawn."""
    stack = params["stack"]
    if "mamba" not in stack:
        return params
    rng = np.random.default_rng(seed)
    draw = lambda a, lo, hi: jnp.asarray(rng.uniform(lo, hi, a.shape), a.dtype)
    stack["lora"] = jax.tree.map(lambda a: draw(a, -0.04, 0.04), stack["lora"])
    stack["mamba"]["ssm"]["dt_bias"] = draw(stack["mamba"]["ssm"]["dt_bias"], -5.0, -4.0)
    return params


@lru_cache(maxsize=None)
def reference(arch, s, change=()):
    """(params as numpy, batch, loss, metrics, grads, logits) of the
    reference in float32 on ``B`` x ``s`` tokens; ``change``: config
    fields replaced, as (name, value) pairs."""
    ref = RModel(f32(r_get_smoke(arch), **dict(change)))
    params = draw_finite(ref.init(jax.random.PRNGKey(0)))
    bt = batch(ref.cfg, B, s)
    bt["labels"][0, :3] = -1
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    old = RModel.LOSS_CHUNK
    RModel.LOSS_CHUNK = CHUNK
    try:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
            params, jb)
        logits = np.asarray(jax.jit(ref.forward)(params, jb)[0])
    finally:
        RModel.LOSS_CHUNK = old
    return (jax.tree.map(np.asarray, params), bt, float(loss),
            {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads),
            logits)


def unsharded(arch, s, change=()):
    params, *_ = reference(arch, s, change)
    return convert.lm_params_from_reference(params, f32(get_smoke(arch), **dict(change)),
                                             device="cpu").requires_grad_()


def rows(x, comm):
    """Each rank's rows of a (B, ...) global batch: data row d's."""
    if x is None:
        return None
    n = x.shape[0] // comm.data
    return [x[r // comm.model * n:(r // comm.model + 1) * n] for r in range(comm.ranks)]


def join(comm, outs, dim):
    """Per-rank outputs joined on ``dim`` over each row (None: the row's
    first), then over rows."""
    m = comm.model
    return torch.cat([torch.cat(outs[i:i + m], dim) if dim is not None else outs[i]
                      for i in range(0, comm.ranks, m)], 0)


def check_local_shapes(arch, mesh):
    d, m = mesh
    cfg = get_config(arch)
    shapes = {n: tuple(p.shape) for n, p in
              CausalLM(cfg, device="meta", seed=None).named_parameters()}
    specs = param_specs(shapes, tp.rules_for(cfg, d, m))
    split = 0
    for model in tp.local_ranks(cfg, LocalComm(d, m), seed=None, device="meta"):
        got = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert got.keys() == shapes.keys()
        for name, shape in shapes.items():
            dim = tp.model_dim(specs[name])
            want = list(shape)
            if dim is not None:
                want[dim] //= m
                split += 1
                *path, leaf = name.split(".")
                assert leaf in model.get_submodule(".".join(path)).tp_split, name
            assert got[name] == tuple(want), name
    return split


def check_train(arch, mesh, s, monkeypatch, change=()):
    monkeypatch.setattr(CausalLM, "LOSS_CHUNK", CHUNK)
    params, bt, r_loss, r_metrics, r_grads, r_logits = reference(arch, s, change)
    one = unsharded(arch, s, change)
    comm = LocalComm(*mesh)
    ranks = tp.split_ranks(one, comm)
    tokens, labels = torch.as_tensor(bt["tokens"]).long(), torch.as_tensor(bt["labels"])
    prefix = bt.get("prefix_embeds")
    prefix = None if prefix is None else torch.as_tensor(prefix)

    want_logits = one.forward(tokens, prefix_embeds=prefix)[0].detach()
    loss, metrics = one.loss(tokens, labels, prefix_embeds=prefix)
    loss.backward()
    with torch.no_grad():
        got = forward_ranks(ranks, rows(tokens, comm), rows(prefix, comm))[0]
    vocab = -1 if ranks[0]._vocab_split() and one.cfg.family != "audio" else None
    got = join(comm, got, vocab)
    assert rel(got.numpy(), want_logits.numpy()) <= 1e-5
    assert rel(got.numpy(), r_logits) <= 1e-5

    outs = loss_ranks(ranks, rows(tokens, comm), rows(labels, comm), rows(prefix, comm))
    sum(o[0] for o in outs).backward()
    for lo, mo in outs:
        assert rel(float(lo.detach()), float(loss.detach())) <= 1e-5
        assert rel(float(lo.detach()), r_loss) <= 1e-5
        for key in ("ce", "aux"):
            assert rel(float(mo[key].detach()), float(metrics[key].detach())) <= 1e-5, key
            assert rel(float(mo[key].detach()), r_metrics[key]) <= 1e-5, key
    specs = param_specs({n: p.shape for n, p in one.named_parameters()},
                        tp.rules_for(one.cfg, *mesh))
    for name, p in one.named_parameters():
        g = tp.whole(comm, [dict(r.named_parameters())[name].grad for r in ranks],
                     specs[name], grads=True)
        assert rel(g.numpy(), p.grad.numpy()) <= 1e-5, name
        assert rel(g.numpy(), ref_leaf(r_grads, name)) <= 1e-5, name
    return ranks


def cache_shapes_of(cfg, batch_size, max_len, mesh):
    """{leaf path: the local shape ``cache_specs`` gives a rank of
    ``mesh``} of the config's decode cache."""
    cache = init_cache(cfg, batch_size, max_len, torch.float32, "meta")
    specs = cache_specs(cfg, cache, tp.rules_for(cfg, *mesh, kind="decode"))
    sizes = {"data": mesh[0], "model": mesh[1]}
    out = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], path + (k,))
            return
        shape = list(node.shape)
        for i, ax in enumerate(spec):
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                shape[i] //= sizes.get(a, 1)
        out[path] = tuple(shape)

    walk(cache, specs, ())
    return out


def _leaf_shapes(cache, path=()):
    out = {}
    for k, v in cache.items():
        out.update(_leaf_shapes(v, path + (k,)) if isinstance(v, dict)
                   else {path + (k,): tuple(v.shape)})
    return out


def check_serving(arch, mesh, prompt=24, steps=3, change=()):
    cfg = f32(get_smoke(arch), **dict(change))
    one = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
    comm = LocalComm(*mesh)
    ranks = tp.split_ranks(one, comm)
    gen = torch.Generator().manual_seed(1)
    k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    toks = torch.randint(0, cfg.vocab_size, (2, prompt) + k, generator=gen)
    prefix = (torch.randn(2, cfg.prefix_tokens, cfg.d_model, generator=gen)
              if cfg.family == "vlm" else None)
    s = prompt + (0 if prefix is None else cfg.prefix_tokens)
    max_len = s + 16
    want, cache = one.prefill(toks, max_len, torch.float32, prefix_embeds=prefix)
    got, caches = prefill_ranks(ranks, rows(toks, comm), max_len, torch.float32,
                                rows(prefix, comm))
    assert rel(join(comm, got, None).numpy(), want.numpy()) <= 1e-5
    shapes = cache_shapes_of(cfg, 2, max_len, mesh)
    for c in caches:
        assert _leaf_shapes(c) == shapes
    nxt, mine = want.argmax(-1), [g.argmax(-1) for g in got]
    for i in range(steps):
        want, cache = one.decode_step(nxt, cache, s + i)
        got, caches = decode_ranks(ranks, mine, caches, s + i)
        assert rel(join(comm, got, None).numpy(), want.numpy()) <= 1e-5, i
        nxt, mine = want.argmax(-1), [g.argmax(-1) for g in got]
        assert torch.equal(join(comm, mine, None), nxt)
    return caches


__all__ = ["B", "check_local_shapes", "check_serving", "check_train", "f32", "join",
           "reference", "rows", "unsharded"]
