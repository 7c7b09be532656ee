"""The LM across ranks: the reference's placement rules
(``repro_torch.dist.sharding``) on a (data D, model M) mesh of ranks, one
process a rank.

* The global batch goes over "data": the M ranks of data row d take shard
  d of D of it.
* Over "model" the rank holds and computes what ``repro_torch.dist.tp``
  says: tensor parallelism of heads, ff and vocab, the stream split over
  the sequence between layers (train and prefill), and expert parallelism
  of the MoE's routed experts.  Its parameters are their shards under
  ``param_specs`` over "model".
* ZeRO-3 goes over "data" only: ``torch.distributed.fsdp.fully_shard`` on
  each body that ``stack_forward`` checkpoints (a block or a local/global
  pair) and on the root (embedding, final norm, head), over the D ranks
  of the rank's "model" coordinate, each leaf on the dim the rules give
  ZeRO (``zero_dim``).  A leaf the rules give no ZeRO dim stays whole on
  every data rank (FSDP ignores it).  With D = 1 nothing is FSDP'd.

Gradients: each rank's loss carries 1/M into the backward, so the sum of
every rank's loss is the sum of the D data rows' losses; FSDP averages
its leaves over "data".  :meth:`Placement.sync_grads` then sums the
leaves that are whole over "model" (norms, biases, the router: each rank
saw its own positions) over the data row, and averages those that FSDP
ignores over "data".  The MoE aux loss averages each rank's mean prob and
token share over every rank (``DistComm.all_mean``), so every rank holds
the global batch's aux.

The model is built on the meta device; then each body is drawn whole on
the rank's card, in ``CausalLM.init``'s order from the same generator,
cut to the rank's "model" shards and sharded over "data" before the next
body exists: no rank ever holds the whole model, and a ranked model from
seed s holds the values of an unsharded model from seed s.

Ported: the dense and moe families; the ssm, hybrid, vlm and audio
families are refused (ROADMAP §1 item 6).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor, Shard

from ..models.config import ModelConfig
from ..models.layers import param_init
from ..models.model import CausalLM
from ..models.moe import MoE
from ..optim.adamw import _local
from . import tp
from .comm import DistComm
from .sharding import make_rules_for, param_specs, zero_dim

FAMILIES = tp.FAMILIES


class Placement:
    """Where a ranked model's parameters live: the (data, model) mesh, a
    1-D mesh over all W ranks, this rank's "model" comm and each
    parameter's spec under the reference's rules."""

    def __init__(self, cfg: ModelConfig, mesh, shapes: dict):
        self.mesh = mesh
        self.data, self.model = mesh.mesh.shape
        self.ranks = self.data * self.model
        self.rank = dist.get_rank()
        self.model_rank = mesh.get_local_rank("model")
        self.data_rank = mesh.get_local_rank("data")
        self.world = init_device_mesh(mesh.device_type, (self.ranks,),
                                      mesh_dim_names=("world",))
        self.comm = DistComm(mesh.get_group("model"), self.world.get_group())
        self.rules = make_rules_for(cfg, mesh)
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.specs = param_specs(shapes, self.rules)

    def model_dim(self, name: str) -> int | None:
        """The dim of ``name`` split over "model" (None: whole on the row)."""
        return tp.model_dim(self.specs[name]) if self.model > 1 else None

    def zero_dim(self, name: str) -> int | None:
        """The dim FSDP shards ``name`` on over "data" (None: whole)."""
        if self.data == 1:
            return None
        i = zero_dim(self.specs[name], self.rules)
        return i if i is not None and self.shapes[name][i] % self.data == 0 else None

    def shard_fn(self, names: dict):
        """FSDP2's ``shard_placement_fn`` for parameters named by ``names``
        ({parameter: name})."""
        return lambda p: Shard(self.zero_dim(names[p]))

    def replicas(self, name: str) -> int:
        """How many ranks hold each element of ``name``."""
        return ((self.model if self.model_dim(name) is None else 1)
                * (self.data if self.zero_dim(name) is None else 1))

    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of a parameter (or its gradient or AdamW moment)
        on every rank: gathered over "data" and over "model".  Every rank
        must call it, leaf by leaf in one order."""
        x = t.full_tensor() if isinstance(t, DTensor) else t
        dim = self.model_dim(name)
        if dim is not None:
            parts = [torch.empty_like(x) for _ in range(self.model)]
            dist.all_gather(parts, x.contiguous(), group=self.mesh.get_group("model"))
            x = torch.cat(parts, dim)
        return x

    def local(self, name: str, like: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``full`` of parameter
        ``name``, shaped as ``like``'s local shard (``like`` a parameter
        or moment)."""
        dim = self.model_dim(name)
        if dim is not None:
            full = full.chunk(self.model, dim)[self.model_rank]
        if not isinstance(like, DTensor):
            return full
        (place,) = like.placements
        return full.chunk(self.data, place.dim)[self.data_rank]

    @torch.no_grad()
    def sync_grads(self, params: dict) -> None:
        """After the backward: each leaf whole over "model" summed over the
        data row, each leaf that FSDP leaves whole averaged over "data"
        (in one flat all-reduce per kind)."""
        kinds: dict = {}
        for name, p in params.items():
            if p.grad is None:
                continue
            over_model = self.model > 1 and self.model_dim(name) is None
            over_data = self.data > 1 and self.zero_dim(name) is None
            if over_model or over_data:
                kinds.setdefault((over_model, over_data), []).append(_local(p.grad))
        for (over_model, over_data), grads in kinds.items():
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            group = (self.world.get_group() if over_model and over_data else
                     self.mesh.get_group("model" if over_model else "data"))
            dist.all_reduce(flat, group=group)
            if over_data:
                flat /= self.data
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))


def _bodies(model: CausalLM):
    """(name prefix, body) of every scanned body, in ``init``'s order."""
    layers = model.layers
    groups = layers.items() if isinstance(layers, nn.ModuleDict) else [("", layers)]
    for group, blocks in groups:
        for i, block in enumerate(blocks):
            yield f"layers.{group + '.' if group else ''}{i}", block


def _names(module: nn.Module, prefix: str, recurse: bool = True) -> dict:
    return {p: f"{prefix}{'.' if prefix else ''}{n}"
            for n, p in module.named_parameters(recurse=recurse)}


def ranked_lm(cfg: ModelConfig, mesh, seed: int | None = 0) -> CausalLM:
    """``cfg``'s model for this rank of ``mesh`` (``launch.mesh.
    make_lm_mesh``): parameters in ``cfg.param_dtype`` on the rank's
    device (the card, or the CPU for a gloo mesh), placed as the module
    docstring says, drawn from ``seed`` as ``CausalLM(cfg, seed=seed)``
    draws them (``seed=None``: left for a caller to load,
    ``convert.load_params``).  ``model.placement`` describes where each
    parameter lives; ``model.loss`` and ``model.forward`` gather around
    themselves, and so do ``prefill`` and ``decode_step``."""
    tp.check_tp(cfg, 1 if mesh is None else mesh.mesh.shape[1])
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    with torch.no_grad():
        model = _build(cfg, mesh, dev, seed)
    if model.placement.data > 1:
        register_fsdp_forward_method(model, "loss")
    return model


def _build(cfg: ModelConfig, mesh, dev: torch.device, seed: int | None) -> CausalLM:
    model = CausalLM(cfg, device="meta", seed=None)
    place = Placement(cfg, mesh, {n: p.shape for n, p in model.named_parameters()})
    model.device, model.placement = dev, place
    m, M = place.model_rank, place.model
    data_mesh = mesh["data"]
    gen = torch.Generator(device=dev)
    if seed is not None:
        gen.manual_seed(seed)

    def cut(module, prefix, recurse=True):
        """To this rank's "model" shards."""
        if M > 1:
            tp.shard_module_(module, prefix, place.specs, m, M, recurse)

    def zero(module, prefix, recurse=True):
        """ZeRO-3 over "data"; leaves with no ZeRO dim stay whole."""
        if place.data > 1:
            names = _names(module, prefix, recurse)
            whole = {p for p, n in names.items() if place.zero_dim(n) is None}
            fully_shard(module, mesh=data_mesh, ignored_params=whole or None,
                        shard_placement_fn=place.shard_fn(names))

    model.to_empty(device=dev, recurse=False)
    if seed is not None:
        param_init(model.embed, gen)
    for prefix, body in _bodies(model):
        if seed is None:
            cut(body, prefix)                 # on the meta device
            body.to_empty(device=dev)
        else:
            body.to_empty(device=dev)
            body.reset_parameters(gen)        # drawn whole, then cut
            cut(body, prefix)
        zero(body, prefix)
    if seed is not None:
        model.final_norm.fill_(0.0 if cfg.post_norms else 1.0)
        if not cfg.tie_embeddings:
            param_init(model.lm_head, gen)
    for moe in model.modules():
        if isinstance(moe, MoE):
            moe.comm = place.comm
    cut(model, "", recurse=False)
    if M > 1:
        tp.attach(model, tp.Rank(place.comm, m, M, place.rules))
    zero(model, "", recurse=False)
    return model


__all__ = ["FAMILIES", "Placement", "ranked_lm"]
