"""Tensor and sequence parallelism over the "model" axis for every family
(dense, vlm, audio, moe, ssm, hybrid): the reference's rules
(``repro_torch.dist.sharding``) acting as its ``shard`` annotations and
``param_specs`` make them act inside ``jax.jit``.

On a (data D, model M) mesh with M > 1, model rank m of a data row holds:

* the columns of ``wq``/``wk``/``wv`` and of the MLP's ``up``/``gate``
  that its heads and its ff slice read (column-parallel), the matching
  rows of ``wo`` and ``down`` (row-parallel), and the rows [m V/M,
  (m+1) V/M) of the embedding table (and the columns of an untied head):
  each leaf is its shard under ``param_specs`` over "model";
* experts m E/M .. (m+1) E/M - 1 of each MoE layer (expert parallelism,
  ``models.moe.moe_ffn_ep``);
* every other leaf whole: norms, the router, the QKV biases and the MoE's
  shared experts, which no rule names.  A rank reads the bias columns of
  its own heads and the shared experts' columns of its ff slice (their
  activation rule, ``mlp.py:32``, splits their hidden over "model").

Activations follow the reference's annotations.  In training and in
prefill (``seq_act`` is "model") the stream between layers is split over
the sequence: rank m holds positions [m S/M, (m+1) S/M) of its data
row's rows (``transformer.py:111``, ``:162``).  Norms and residuals run
on that shard.  Before each column-parallel product the shards are
all-gathered over the sequence, and after each row-parallel product the
partial sums are reduce-scattered back onto it.  Attention therefore sees
the whole sequence for the rank's H/M heads (the reference's q/k/v
``("batch", None, "heads", None)``, ``attention.py:84-86``), and RoPE
takes the gathered sequence's own positions.  The MoE's routed experts
take the rank's shard of tokens, the reference's ``(dp, sp)`` layout
(``transformer.py:160``).  In one-token decode (``seq_act`` None), and
wherever a sequence does not divide by M (the rules' ``fit`` drops the
axis), the stream is whole on every rank and an all-reduce replaces the
reduce-scatter.

Where the query heads do not divide by M (the production mesh's M = 16
against starcoder2's 24, qwen1.5's 40, gemma2's and paligemma's 8 heads)
``wq`` is still split on its columns as the spec says, so a shard cuts a
head: the q projection is gathered over "model", every rank attends with
every head (duplicate work: M times the attention's products), and each
rank takes its own columns of the attention output before ``wo``'s row
shard (``models.attention.cut_heads``).  The dense and vlm families only.

Where the KV heads do not divide by M (starcoder2 and chatglm3 have 2),
``wk``/``wv`` are still split on their columns as the spec says; the
projections are all-gathered over "model", and each rank attends with
the KV heads its own query heads read (the reference's activation rule
replicates K and V there: ``fit`` drops the axis).  The cache then holds
every KV head on every rank, as ``cache_specs`` places it.

The embedding is vocab-parallel (ids outside the rank's rows give zeros,
then a sum over "model"; a vlm's prefix is added after that sum), the
logits stay split over the vocabulary (``model.py:114``), and the cross
entropy takes each row's maximum and log-sum-exp over "model".  gemma2's
final softcap is elementwise, before it.  The audio family's tables (K,
V, D) split on V like the text table; its head (D, K V) splits on its
codebook-major columns, so a rank holds whole codebooks or a part of
one, and the maximum and log-sum-exp of each codebook reduce over the
ranks that hold its columns (the others add -inf and 0).

The other families, by the same name rules.  rwkv6 (``models.rwkv6``):
``tmix.wk``/``wv`` on their columns (heads), ``tmix.wo`` on its rows,
``cmix.wk`` on its ff columns and ``cmix.wv`` (d_ff, d) on its output
columns (the name ``wv``); ``wr``, ``wg``, the decay, ``u``, the norms
and the mixes whole, a rank reading its heads' columns.  A rank runs its
H/M heads' WKV and group norm on the gathered sequence; where a head is
cut (40 heads at M = 16) the projections are gathered and every head
computed, and the state holds every head, as ``cache_specs`` places it.
zamba2 (``models.mamba2``, ``transformer.SharedAttn``): no rule names a
Mamba2 leaf, so each rank runs every Mamba2 layer whole on the gathered
sequence and keeps its own positions; decode steps the rank's heads of
the ``ssm`` state (sum of squares and ``out_proj`` summed over "model").
The shared block runs as a dense block, its LoRA leaves whole.

This module places the parameters and marks each block with its
``Rank``; the passes are the model's own (``models.model.*_ranks``,
``models.transformer``, ``attention_ranks``, ``mlp_ranks``,
``moe_ranks``), which take one model a rank that the comm runs in this
process, in rank order (``dist.comm``): all W ranks with ``LocalComm``
(CPU tests, or M ranks on one card), this process's one with
``DistComm``, and an unsharded model as the one rank ``SOLO``, whose
collectives are the identity.  Each collective differentiates as the sum
of every rank's loss; a ranked loss carries 1/M into its gradient, so
that the M copies of a data row's loss count once.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..models.moe import Experts, MoE
from ..models.rwkv6 import RWKVLayer
from ..models.transformer import DenseBlock, MambaLayer, MoEBlock, SharedAttn
from .comm import Rank
from .sharding import make_rules_for, param_specs

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")


# --------------------------------------------------------------------------
# placing the parameters
# --------------------------------------------------------------------------
def model_dim(spec: tuple) -> int | None:
    """The dim of a parameter spec that is split over "model", or None."""
    for i, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return i
    return None


def check_tp(cfg, model: int) -> None:
    """Raise unless this config's leaves and activations split over
    ``model`` ranks as the rules place them.  What cannot be split: a
    query head of an attention layer (attention's unit: each rank attends
    with whole query heads), an expert, and an audio head whose codebook
    blocks and column shards neither hold whole codebooks nor cut one
    evenly.  A column shard that holds a fraction of a KV head (paligemma's
    one KV head) or of an rwkv6 head is gathered over "model" instead, and
    so is one that cuts a query head of the dense and vlm families (the
    reference's rules split ``wq``'s columns where its heads do not divide:
    ``models.attention.cut_heads``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family has no placement "
                                  f"across ranks (families: {', '.join(FAMILIES)})")
    if model == 1:
        return
    if cfg.family != "ssm" and cfg.n_heads % model and (
            cfg.family not in ("dense", "vlm") or cfg.n_heads * cfg.hd % model):
        raise NotImplementedError(f"{cfg.name}: {cfg.n_heads} query heads do not split over "
                                  f"{model} model ranks")
    if cfg.moe is not None and cfg.moe.n_experts % model:
        raise NotImplementedError(f"{cfg.name}: {cfg.moe.n_experts} experts do not split "
                                  f"over {model} model ranks")
    if cfg.family == "audio" and not cfg.tie_embeddings:
        cols, v = cfg.num_codebooks * cfg.vocab_size, cfg.vocab_size
        part = cols // model
        if cols % model == 0 and part % v and v % part:
            raise NotImplementedError(
                f"{cfg.name}: the head's {cols} codebook-major columns split into shards "
                f"of {part}, which neither hold whole codebooks of {v} nor cut one evenly")


def shard_module_(module: nn.Module, prefix: str, specs: dict, m: int, M: int,
                  recurse: bool = True) -> None:
    """Replace each parameter of ``module`` (named ``prefix.name`` in
    ``specs``; its own only, without ``recurse``) that its spec splits
    over "model" by its chunk ``m`` of ``M`` on that dim (on the meta
    device: a meta tensor of that shape), and note the leaf in its owner's
    ``tp_split``."""
    for name, p in list(module.named_parameters(recurse=recurse)):
        full = f"{prefix}.{name}" if prefix else name
        dim = model_dim(specs[full])
        if dim is None:
            continue
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path))
        part = p.detach().chunk(M, dim)[m].clone()
        owner._parameters[leaf] = nn.Parameter(part, requires_grad=p.requires_grad)
        owner.__dict__.setdefault("tp_split", set()).add(leaf)
        if isinstance(owner, Experts):
            owner.lo = m * part.shape[0]


def attach(model: nn.Module, rank: Rank) -> None:
    """Mark ``model`` (a CausalLM) and each of its blocks as rank
    ``rank``'s."""
    model.tp = rank
    for module in model.modules():
        if isinstance(module, (DenseBlock, MoEBlock, RWKVLayer, MambaLayer, SharedAttn)):
            module.tp = rank
        if isinstance(module, MoE):
            module.comm = rank.comm


def rules_for(cfg, data: int, model: int, kind: str = "train") -> dict:
    return make_rules_for(cfg, {"data": data, "model": model}, kind=kind)


def local_ranks(cfg, comm, seed: int | None = 0, device=None) -> list:
    """The W = D x M rank models of ``comm`` (a ``LocalComm``) in this
    process, each holding its shards of the unsharded model that
    ``CausalLM(cfg, device, seed)`` draws (``seed=None``: left for a
    caller to fill; on the meta device, shapes only)."""
    from ..models.model import CausalLM

    check_tp(cfg, comm.model)
    return split_ranks(CausalLM(cfg, device=device, seed=seed), comm)


def split_ranks(full, comm) -> list:
    """The W rank models of ``comm`` (a ``LocalComm``), each holding its
    shards of the unsharded model ``full`` (which stays whole)."""
    cfg = full.cfg
    check_tp(cfg, comm.model)
    rules = rules_for(cfg, comm.data, comm.model)
    specs = param_specs({n: p.shape for n, p in full.named_parameters()}, rules)
    out = []
    for r in range(comm.ranks):
        model = copy.deepcopy(full)
        m = r % comm.model
        shard_module_(model, "", specs, m, comm.model)
        attach(model, Rank(comm, m, comm.model, rules))
        out.append(model)
    return out


def whole(comm, tensors: list, spec: tuple, grads: bool = False) -> torch.Tensor:
    """The whole leaf from one tensor a rank of ``comm`` (a ``LocalComm``):
    its values (data row 0's slices joined on the leaf's "model" dim), or
    with ``grads`` its gradients, summed over the ranks that hold the same
    slice and divided by D (the sum of every rank's loss is the sum of the
    D rows' losses)."""
    dim = model_dim(spec)
    rows = [tensors[i:i + comm.model] for i in range(0, comm.ranks, comm.model)]
    if not grads:
        return torch.cat(rows[0], dim) if dim is not None else rows[0][0]
    if dim is not None:
        parts = [sum(row[m] for row in rows) for m in range(comm.model)]
        return torch.cat(parts, dim) / comm.data
    return sum(t for row in rows for t in row) / comm.data


__all__ = ["FAMILIES", "Rank", "attach", "check_tp", "local_ranks", "model_dim",
           "rules_for", "shard_module_", "split_ranks", "whole"]
