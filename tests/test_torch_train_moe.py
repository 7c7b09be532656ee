"""Training of the MoE family on the CPU against the JAX package:
deepseek-moe-16b (one dense layer, then MoE layers with shared experts)
and moonshot-v1-16b-a3b.  The gradient runs through the router's softmax
and top-k weights, the sort-based capacity dispatch, the fixed-order
combine and the Switch aux loss.

Parameters come from the JAX ``CausalLM.init``, carried across with
``repro_torch.convert``; models compute in float32.  Tolerances
(``_train_parity``): loss, ce, aux and every gradient 1e-5 relative (to
the leaf's largest gradient); three train steps with losses, aux and grad
norms to 1e-5 and parameters to 1e-4.  A checkpointed MoE block runs its
forward again in the backward: that recompute must route every token as
the first forward did, so its outputs, aux and gradients equal the
unchecked block's bit for bit.
"""
import dataclasses

import pytest
import torch

from _train_parity import check_loss_and_grads, check_three_steps
from repro_torch.configs import get_smoke
from repro_torch.models import moe as PMoE
from repro_torch.models import transformer
from repro_torch.models.model import CausalLM

ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    assert check_loss_and_grads(arch, monkeypatch) > 0.0      # the aux is live


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    check_three_steps(arch)


def test_checkpointed_moe_block_routes_as_its_first_forward():
    """deepseek's smoke at capacity factor 1.0, so the dispatch drops
    tokens: a block under ``torch.utils.checkpoint`` (its forward runs
    twice) gives the unchecked block's outputs, aux, input gradient and
    parameter gradients bit for bit."""
    base = get_smoke("deepseek-moe-16b")
    cfg = dataclasses.replace(base, dtype="float32",
                              moe=dataclasses.replace(base.moe, capacity_factor=1.0))
    block = CausalLM(cfg, device="cpu", seed=0).layers["moe_layers"][0]
    acfg = transformer.attn_cfg_for(cfg, None)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 32, cfg.d_model, generator=gen)
    weight = torch.randn(x.shape, generator=gen)
    positions = torch.arange(32).expand(2, 32)
    inputs = []
    block.moe.register_forward_pre_hook(lambda mod, args: inputs.append(args[0].detach()))

    def run(fn):
        xg = x.clone().requires_grad_()
        block.zero_grad(set_to_none=True)
        out, aux = fn(block, xg, acfg, positions)
        ((out * weight).sum() + aux).backward()
        return [out.detach(), aux.detach(), xg.grad] + [p.grad for p in block.parameters()]

    plain = run(lambda f, *a: f(*a))
    assert len(inputs) == 1
    checked = run(transformer._remat)
    assert len(inputs) == 3 and torch.equal(inputs[1], inputs[2])   # recomputed
    tokens = inputs[0].reshape(-1, cfg.d_model)
    _, _, top_e = PMoE.route(block.moe.router, tokens, cfg.moe)
    _, _, keep = PMoE.dispatch(top_e.sort(-1)[0].reshape(-1), cfg.moe.n_experts,
                               PMoE.capacity(cfg.moe, tokens.shape[0]))
    assert not bool(keep.all())                                     # drops
    for a, b in zip(plain, checked):
        assert torch.equal(a, b)
