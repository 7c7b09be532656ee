"""The LM across ranks: ZeRO-3 over the ranks of a (data D, model M) mesh
and expert parallelism over its "model" axis (the reference's placement
rules, ``repro_torch.dist.sharding``, carried out with FSDP2).

Every rank holds its own rows of the global batch and runs the whole
stack on them; activations never leave the rank, except the MoE tokens
that the all-to-alls of ``moe_ffn_ep`` carry to their experts.

* Dense parameters are sharded over all W = D x M ranks:
  ``torch.distributed.fsdp.fully_shard`` on each body that
  ``stack_forward`` checkpoints (a block or a local/global pair) and on the
  root (embedding, final norm, head).  Each gathers its parameters around
  its forward and again in its backward, and reduce-scatters its
  gradients, averaged over the W ranks.  The dim a leaf is sharded on is
  the one the reference's rules give ZeRO (``zero_dim``) where it divides
  by the shard count, else dim 0.
* Where the rules split a MoE's experts over "model" (M > 1 and E
  divisible by M), model rank m holds experts m E/M .. (m+1) E/M - 1
  (``Experts.lo``), sharded over the D ranks of "data" by their own
  ``fully_shard`` (whole, with D = 1).  Their tokens come from all M ranks
  of the data row, so their gradient, summed over "data", is already the
  sum over all W ranks' tokens: it is divided by W, not by D.
* The MoE aux loss averages each rank's mean prob and token share over
  every rank (``DistComm.all_mean``), so every rank holds the global
  batch's aux.

The model is built on the meta device; then each body is drawn whole on
the rank's card, in ``CausalLM.init``'s order from the same generator, its
experts cut to the rank's and sharded, before the next body exists: no
rank ever holds the whole model, and a ranked model from seed s holds the
values of an unsharded model from seed s.

Ported: the dense and moe families.  Tensor and sequence parallelism over
"model" and the other families across ranks are not (ROADMAP).
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
from ..models.moe import Experts, MoE
from .comm import DistComm
from .sharding import is_expert, make_rules_for, param_specs, zero_dim

FAMILIES = ("dense", "moe")


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
        self.world = init_device_mesh(mesh.device_type, (self.ranks,),
                                      mesh_dim_names=("world",))
        self.comm = DistComm(mesh.get_group("model"), self.world.get_group())
        self.rules = make_rules_for(cfg, mesh)
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.specs = param_specs(shapes, self.rules)
        self.n_experts = cfg.moe.n_experts if cfg.moe is not None else 0

    def is_expert(self, name: str) -> bool:
        return is_expert(self.specs[name])

    def expert_rows(self) -> slice:
        e_loc = self.n_experts // self.model
        return slice(self.model_rank * e_loc, (self.model_rank + 1) * e_loc)

    def shard_fn(self, names: dict, shards: int):
        """FSDP2's ``shard_placement_fn`` for parameters named by
        ``names`` ({parameter: name}) over ``shards`` ranks: the rules'
        ZeRO dim where it divides (FSDP2 shards other dims only evenly),
        else dim 0."""
        def fn(p):
            i = zero_dim(self.specs[names[p]], self.rules)
            return Shard(i) if i is not None and p.shape[i] % shards == 0 else None
        return fn

    @torch.no_grad()
    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of a parameter (or its gradient or AdamW moment)
        on every rank: gathered over its shard ranks and, for experts,
        over "model".  Every rank must call it, leaf by leaf in one order."""
        x = t.full_tensor() if isinstance(t, DTensor) else t
        if self.is_expert(name) and self.model > 1:
            parts = [torch.empty_like(x) for _ in range(self.model)]
            dist.all_gather(parts, x.contiguous(), group=self.mesh.get_group("model"))
            x = torch.cat(parts)
        return x

    def local(self, name: str, like: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``full`` of parameter
        ``name``, shaped as ``like``'s local shard (``like`` a DTensor
        parameter or moment)."""
        if self.is_expert(name) and self.model > 1:
            full = full[self.expert_rows()]
        if not isinstance(like, DTensor):
            return full
        (place,) = like.placements
        chunks = torch.chunk(full, like.device_mesh.size(), dim=place.dim)
        i = like.device_mesh.get_local_rank()
        return chunks[i] if i < len(chunks) else full.narrow(place.dim, 0, 0)


def _bodies(model: CausalLM):
    """(name prefix, body) of every scanned body, in ``init``'s order."""
    layers = model.layers
    groups = layers.items() if isinstance(layers, nn.ModuleDict) else [("", layers)]
    for group, blocks in groups:
        for i, block in enumerate(blocks):
            yield f"layers.{group + '.' if group else ''}{i}", block


def _names(module: nn.Module, prefix: str) -> dict:
    return {p: f"{prefix}{'.' if prefix else ''}{n}" for n, p in module.named_parameters()}


def ranked_lm(cfg: ModelConfig, mesh, seed: int | None = 0) -> CausalLM:
    """``cfg``'s model for this rank of ``mesh`` (``launch.mesh.
    make_lm_mesh``): parameters in ``cfg.param_dtype`` on the rank's
    device (the card, or the CPU for a gloo mesh), sharded as the module
    docstring says, drawn from ``seed`` as ``CausalLM(cfg, seed=seed)``
    draws them (``seed=None``: left for a caller to load,
    ``convert.load_params``).  ``model.placement`` describes where each
    parameter lives; ``model.loss`` and ``model.forward`` gather around
    themselves."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family does not train across ranks in "
            f"repro_torch (ported: {', '.join(FAMILIES)}; ROADMAP §1)")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    with torch.no_grad():
        model = _build(cfg, mesh, dev, seed)
    register_fsdp_forward_method(model, "loss")
    return model


def _build(cfg: ModelConfig, mesh, dev: torch.device, seed: int | None) -> CausalLM:
    model = CausalLM(cfg, device="meta", seed=None)
    place = Placement(cfg, mesh, {n: p.shape for n, p in model.named_parameters()})
    model.device, model.placement = dev, place
    gen = torch.Generator(device=dev)
    if seed is not None:
        gen.manual_seed(seed)
    model.to_empty(device=dev, recurse=False)
    if seed is not None:
        param_init(model.embed, gen)
    for prefix, body in _bodies(model):
        for sub, moe in body.named_modules():
            if not isinstance(moe, MoE):
                continue
            moe.comm = place.comm
            up = f"{prefix}.{sub}.experts.up"
            if place.is_expert(up):
                rows = place.expert_rows()
                old = moe.experts
                moe.experts = Experts(old.up.shape[1], old.up.shape[2], old.n_experts,
                                      old.kind, lo=rows.start, n=rows.stop - rows.start,
                                      device="meta", dtype=old.up.dtype)
        body.to_empty(device=dev)
        if seed is not None:
            body.reset_parameters(gen)
        unsharded = set()
        for sub, moe in body.named_modules():
            if not (isinstance(moe, MoE) and place.is_expert(f"{prefix}.{sub}.experts.up")):
                continue
            if place.data == 1:
                # nothing to shard over; FSDP2 would divide a one-rank
                # group's gradient twice by a custom factor
                for p in moe.experts.parameters():
                    p.register_hook(lambda g, w=place.ranks: g / w)
                    unsharded.add(p)
                continue
            fully_shard(moe.experts, mesh=mesh["data"],
                        shard_placement_fn=place.shard_fn(
                            _names(moe.experts, f"{prefix}.{sub}.experts"), place.data))
            moe.experts.set_gradient_divide_factor(float(place.ranks))
            # a sum, then the division: gloo has no pre-multiplied sum
            moe.experts.set_force_sum_reduction_for_comms(True)
        fully_shard(body, mesh=place.world, ignored_params=unsharded or None,
                    shard_placement_fn=place.shard_fn(_names(body, prefix), place.ranks))
    if seed is not None:
        model.final_norm.fill_(0.0 if cfg.post_norms else 1.0)
        if not cfg.tie_embeddings:
            param_init(model.lm_head, gen)
    own = {p: n for n, p in model.named_parameters(recurse=False)}
    fully_shard(model, mesh=place.world, shard_placement_fn=place.shard_fn(own, place.ranks))
    return model


__all__ = ["FAMILIES", "Placement", "ranked_lm"]
