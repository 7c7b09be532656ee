"""Helpers of the port's training tests (``tests/test_torch_train*.py``):
a reference model and the port model holding its parameters, batches
from the token pipeline, and the two parity checks every family is held
to on the CPU.

* ``check_loss_and_grads``: the loss, its parts and every gradient
  against ``jax.value_and_grad(ref.loss)``, 1e-5 relative (to the leaf's
  largest gradient), over several loss chunks, with masked labels;
* ``check_three_steps``: three ``make_train_step`` steps against the
  reference's jitted step.  Free-running, the losses, parts and grad norms
  are held to 1e-5 relative and the parameters after the third step to
  1e-4 absolute on values of order 0.02: AdamW's g / (sqrt(v) + eps)
  turns a ~1e-7 difference of a gradient near eps (1e-8) into up to a
  full step of lr = 1e-3 in that element.  Where that amplification
  carries past the 1e-4 bound, the models are re-seated instead: before
  each step both packages start from the reference's parameters and AdamW
  state, every gradient is held to 1e-5 and the step's metrics to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models.model import CausalLM as RModel
from repro.optim import adamw as r_adamw
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.data import tokens as p_tokens
from repro_torch.models.model import CausalLM
from repro_torch.optim import adamw as p_adamw
from repro_torch.train.step import make_train_step

METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def pair(arch, seed=0, adjust=None):
    """(reference model, its params, port model holding them), float32.
    ``adjust(params, seed)`` may replace reference parameters first."""
    cfg = f32(r_get_smoke(arch))
    ref = RModel(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    if adjust is not None:
        params = adjust(params, seed)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             f32(get_smoke(arch)),
                                             device="cpu").requires_grad_()
    return ref, params, model


def ref_leaf(tree, name):
    """The reference array of port parameter ``name`` (its layer's slice)."""
    path, layer = convert._reference_path(name)
    for key in path:
        tree = tree[key]
    return np.asarray(tree if layer is None else tree[layer])


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def batch(cfg, b=2, s=32, seed=0):
    """One token-pipeline batch of the config's family: (B, S, K) tokens
    for audio, ``prefix_embeds`` (B, prefix_tokens, D) for a vlm."""
    data = p_tokens.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
        num_codebooks=cfg.num_codebooks if cfg.family == "audio" else 0,
        prefix_tokens=cfg.prefix_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)
    return p_tokens.make_batch(data, 0)


def port_loss(model, bt):
    prefix = bt.get("prefix_embeds")
    return model.loss(torch.as_tensor(bt["tokens"]).long(), torch.as_tensor(bt["labels"]),
                      prefix_embeds=None if prefix is None else torch.as_tensor(prefix))


def _jax_batch(bt):
    return {k: jnp.asarray(v) for k, v in bt.items()}


def _hold_grads(model, r_grads, what):
    for name, p in model.named_parameters():
        assert p.grad is not None, (what, name)
        assert bool(torch.isfinite(p.grad).all()), (what, name)
        assert rel(p.grad.numpy(), ref_leaf(r_grads, name)) <= 1e-5, (what, name)


def check_loss_and_grads(arch, monkeypatch, b=2, s=32, seed=0, adjust=None, chunk=8):
    """Loss, parts and grads against ``jax.value_and_grad``, over loss
    chunks of ``chunk`` positions (both packages), with the first three
    labels of row 0 set to -1 besides the masked last position."""
    monkeypatch.setattr(RModel, "LOSS_CHUNK", chunk)
    monkeypatch.setattr(CausalLM, "LOSS_CHUNK", chunk)
    ref, params, model = pair(arch, seed, adjust)
    bt = batch(ref.cfg, b, s, seed)
    bt["labels"][0, :3] = -1
    (want, r_metrics), r_grads = jax.value_and_grad(ref.loss, has_aux=True)(
        params, _jax_batch(bt))
    loss, metrics = port_loss(model, bt)
    loss.backward()
    assert rel(float(loss.detach()), float(want)) <= 1e-5
    for key in ("ce", "aux"):
        assert rel(float(metrics[key].detach()), float(r_metrics[key])) <= 1e-5, key
    _hold_grads(model, r_grads, "grads")
    return float(metrics["aux"].detach())


def check_three_steps(arch, b=4, s=16, seed=1, adjust=None, reseat=False):
    """Three train steps of both packages on the same batches (see the
    module docstring for ``reseat``)."""
    ref, params, model = pair(arch, seed, adjust)
    rc = r_adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    r_step = jax.jit(r_make_train_step(ref, rc))
    r_grad = jax.jit(jax.grad(lambda p, x: ref.loss(p, x)[0]))
    p_step = make_train_step(model, p_adamw.AdamWConfig(**dataclasses.asdict(rc)))
    r_state = r_adamw.init_state(params)
    p_state = p_adamw.init_state(dict(model.named_parameters()))
    for step in range(3):
        bt = batch(ref.cfg, b, s, seed=step)
        if reseat:
            convert.load_params(model, jax.tree.map(np.asarray, params))
            convert.opt_state_from_reference(jax.tree.map(np.asarray, r_state), p_state)
            port_loss(model, bt)[0].backward()
            _hold_grads(model, r_grad(params, _jax_batch(bt)), f"step {step}")
        params, r_state, r_m = r_step(params, r_state, _jax_batch(bt), jnp.int32(step))
        p_state, p_m = p_step(p_state, bt, step)
        for key in METRICS:
            assert rel(float(p_m[key]), float(r_m[key])) <= 1e-5, (step, key)
    if not reseat:
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref_leaf(params, name),
                                       atol=1e-4, err_msg=name)
