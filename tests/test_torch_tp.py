"""Tensor and sequence parallelism over "model" on the CPU
(``repro_torch.dist.tp``), with every rank of a (data D, model M) mesh in
one process (``LocalComm``) at 1 x 2, 2 x 2 and 1 x 4.

* Placement: each rank's parameters of the full configs (on the meta
  device) are their shards under ``param_specs`` over "model"; ZeRO's
  dp shard is FSDP's, held on gloo ranks (``test_torch_tp_ranks.py``).
* Parity, float32, from the reference's ``CausalLM.init`` carried across
  with ``convert``: the logits (joined over the vocabulary and the data
  rows), the loss (its ce and aux) and every gradient (summed over the
  ranks holding the same slice) within 1e-5 relative of the unsharded
  port and of ``jax.value_and_grad`` on the reference, over several loss
  chunks with masked labels.  gemma2 runs its local/global pairs (the
  local layer's ring cache in serving), post-norms, embedding scale and
  final softcap before the vocab-parallel log-sum-exp.  starcoder2,
  chatglm3 and gemma2's smoke config have 2 KV heads: at
  M = 4 each rank holds half a KV head's columns and gathers K and V.
  The MoEs run at a capacity factor (8.0) that drops no pair: with drops,
  which pairs drop depends on which tokens share a rank.
* Activations: between layers each rank holds its sequence shard (B/D,
  S/M, d); attention sees the whole sequence for H/M heads, the MLP's
  hidden is ff/M wide, the logits V/M; the MoE's routed experts take the
  shard's tokens.
* Serving: prefill and decode logits within 1e-5 of the unsharded port's,
  and each rank's cache holds its KV heads (all of them where they do
  not divide by M).
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_parity import batch, ref_leaf, rel
from repro.configs import get_smoke as r_get_smoke
from repro.models.model import CausalLM as RModel
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist import tp
from repro_torch.dist.comm import LocalComm
from repro_torch.dist.sharding import param_specs
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.model import (CausalLM, decode_ranks, forward_ranks, loss_ranks,
                                      prefill_ranks)

ARCHS = ("starcoder2-3b", "chatglm3-6b", "gemma2-2b", "deepseek-moe-16b",
         "moonshot-v1-16b-a3b")
MESHES = ((1, 2), (2, 2), (1, 4))
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
B, S, CHUNK = 4, 32, 8


def _no_drops(cfg):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@lru_cache(maxsize=None)
def _reference(arch):
    """(params as numpy, batch, loss, metrics, grads, logits) of the
    reference, float32."""
    ref = RModel(_no_drops(r_get_smoke(arch)))
    params = ref.init(jax.random.PRNGKey(0))
    bt = batch(ref.cfg, B, S)
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
            {k: float(v) for k, v in metrics.items()}, grads, logits)


def _unsharded(arch):
    params, *_ = _reference(arch)
    return convert.lm_params_from_reference(params, _no_drops(get_smoke(arch)),
                                             device="cpu").requires_grad_()


def _rows(x, comm):
    """Each rank's rows of a (B, ...) global batch: data row d's."""
    rows = x.shape[0] // comm.data
    return [x[r // comm.model * rows:(r // comm.model + 1) * rows] for r in range(comm.ranks)]


def _join(comm, outs, dim):
    """Per-rank outputs joined on ``dim`` over each row, then over rows."""
    m = comm.model
    return torch.cat([torch.cat(outs[i:i + m], dim) if dim is not None else outs[i]
                      for i in range(0, comm.ranks, m)], 0)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_parameter_shapes_are_the_spec_shards(arch, mesh):
    """Every leaf of the full config on every rank: its shape is the whole
    leaf's with the spec's "model" dim divided by M; the leaves the spec
    keeps whole over "model" are whole, and each split leaf is noted."""
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
    assert split > 0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_unsharded_and_reference(arch, mesh, monkeypatch):
    monkeypatch.setattr(CausalLM, "LOSS_CHUNK", CHUNK)
    params, bt, r_loss, r_metrics, r_grads, r_logits = _reference(arch)
    one = _unsharded(arch)
    comm = LocalComm(*mesh)
    ranks = tp.split_ranks(one, comm)
    tokens, labels = torch.as_tensor(bt["tokens"]).long(), torch.as_tensor(bt["labels"])

    want_logits = one.forward(tokens)[0].detach()
    loss, metrics = one.loss(tokens, labels)
    loss.backward()
    with torch.no_grad():
        got = _join(comm, forward_ranks(ranks, _rows(tokens, comm))[0], -1)
    assert rel(got.numpy(), want_logits.numpy()) <= 1e-5
    assert rel(got.numpy(), r_logits) <= 1e-5

    outs = loss_ranks(ranks, _rows(tokens, comm), _rows(labels, comm))
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


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "moonshot-v1-16b-a3b"])
def test_activations_are_sharded_between_and_inside_layers(arch, mesh, monkeypatch):
    d, m = mesh
    cfg = _no_drops(get_smoke(arch))
    comm = LocalComm(d, m)
    ranks = tp.local_ranks(cfg, comm, seed=0, device="cpu")
    seen: dict = {}

    def record(owner, name, fn, of_output=False):
        orig = getattr(owner, name)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            seen.setdefault(name, set()).add(fn(out) if of_output else fn(*args, **kw))
            return out
        monkeypatch.setattr(owner, name, wrapped)

    record(transformer, "_block", lambda blocks, xs, *a: tuple(tuple(x.shape) for x in xs)[0])
    record(attn_mod, "_attend", lambda q, k, v, c: (tuple(q.shape), tuple(k.shape)))
    record(mlp_mod, "mlp", lambda p, x, kind: (tuple(x.shape), tuple(p["up"].shape)))
    record(CausalLM, "_unembed", lambda out: tuple(out.shape), of_output=True)
    record(moe_mod, "moe_ffn_ep", lambda ps, xs, *a, **k: tuple(xs[0].shape))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    outs = loss_ranks(ranks, _rows(tokens, comm), _rows(tokens, comm))
    sum(o[0] for o in outs).backward()
    b, s, dm, hd = B // d, S // m, cfg.d_model, cfg.hd
    assert seen["_block"] == {(b, s, dm)}                       # the stream: its shard
    kvh = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else 1
    assert seen["_attend"] == {((b, S, cfg.n_heads // m, hd), (b, S, kvh, hd))}
    ffs = {(b, S, dm)}
    assert {x for x, _ in seen["mlp"]} == ffs                    # gathered before
    widths = {w for _, (_, w) in seen["mlp"]}
    want = {(cfg.dense_ff or cfg.d_ff) // m}
    if cfg.moe is not None:
        want.add(cfg.d_ff * cfg.moe.n_shared // m)               # shared experts over ff
        assert seen["moe_ffn_ep"] == {(b, s, dm)}               # the (dp, sp) layout
    assert widths == want
    assert {v for *_, v in seen["_unembed"]} == {cfg.vocab_size // m}


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, mesh):
    cfg = _no_drops(get_smoke(arch))
    one = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
    comm = LocalComm(*mesh)
    ranks = tp.split_ranks(one, comm)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    want, cache = one.prefill(toks, 40, torch.float32)
    got, caches = prefill_ranks(ranks, _rows(toks, comm), 40, torch.float32)
    assert rel(_join(comm, got, None).numpy(), want.numpy()) <= 1e-5
    m = comm.model
    kvh = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else cfg.n_kv_heads
    for c in caches:
        for group in c.values():
            assert group["k"].shape[3] == kvh and group["k"].shape[1] == 2 // comm.data
    nxt, mine = want.argmax(-1), [g.argmax(-1) for g in got]
    for i in range(3):
        want, cache = one.decode_step(nxt, cache, 24 + i)
        got, caches = decode_ranks(ranks, mine, caches, 24 + i)
        assert rel(_join(comm, got, None).numpy(), want.numpy()) <= 1e-5, i
        nxt, mine = want.argmax(-1), [g.argmax(-1) for g in got]
        assert torch.equal(_join(comm, mine, None), nxt)
