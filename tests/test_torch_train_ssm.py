"""Training of the recurrent families on the CPU against the JAX package:
rwkv6-3b and zamba2-2.7b at S 128, so that rwkv6's chunked WKV (chunk 32)
and Mamba2's chunked SSD (chunk 64) run, as they do at train_4k.

F8 (ROADMAP §3): the reference's chunked SSD takes its intra-chunk decay
as ``where(tri, exp(rel), 0)`` (``src/repro/models/mamba2.py:102``).
Above the diagonal ``rel = cum_t - cum_s`` is positive and grows to about
dt A (chunk - 1): with the reference's init (``a_log = log(linspace(1,
16))``, ``dt_bias`` 0, so dt ~ softplus(0) = 0.69) it reaches ~700 in a
64-step chunk, ``exp`` overflows to inf there, and the backward's 0 x inf
turns the gradient NaN while the loss stays finite.  The port takes
``exp(where(tri, rel, -inf))``: the same forward bit for bit and a finite
gradient.  So the port is held to the reference where the reference's
gradient is finite: zamba2's Mamba2 ``dt_bias`` drawn in [-5, -4] (dt of
0.007-0.02, inside Mamba2's own dt range of [1e-3, 1e-1]), which keeps dt A
(chunk - 1) far below exp's overflow at 88.7.  Where the reference
overflows, the port's chunked gradient is held to the exact step scan's,
and the reference's NaN is pinned.  zamba2's LoRA ``a`` and ``b`` are
drawn too (the reference's init starts ``b`` at zeros, which leaves
``a``'s gradient 0).

rwkv6's three free-running steps leave ``embed`` 6.0e-4 from the
reference's and the step-1 grad norm 2.2e-4 apart (B 4, S 128), past the
1e-4 / 1e-5 bounds, while each step's gradients agree to 1e-5: AdamW's eps
amplification (``_train_parity``).  Its steps are re-seated from the
reference's state before each one, every gradient and metric held to
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_parity import check_loss_and_grads, check_three_steps, pair, port_loss
from _train_parity import batch as make_batch
from repro_torch.models import mamba2 as PMamba

ARCHS = ("rwkv6-3b", "zamba2-2.7b")
RESEAT = ("rwkv6-3b",)
S = 128


def _finite_reference(params, seed):
    """zamba2's adapters drawn, and its Mamba2 dt_bias in [-5, -4]."""
    stack = params["stack"]
    if "mamba" not in stack:
        return params
    rng = np.random.default_rng(seed)
    draw = lambda a, lo, hi: jnp.asarray(rng.uniform(lo, hi, a.shape), a.dtype)
    stack["lora"] = jax.tree.map(lambda a: draw(a, -0.04, 0.04), stack["lora"])
    ssm = stack["mamba"]["ssm"]
    ssm["dt_bias"] = draw(ssm["dt_bias"], -5.0, -4.0)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch, s=S, adjust=_finite_reference, chunk=32)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    check_three_steps(arch, s=S, adjust=_finite_reference, reseat=arch in RESEAT)


# --------------------------------------------------------------------------
# the chunked SSD's gradient (F8)
# --------------------------------------------------------------------------
def _ssd_chunked_masked_after_exp(xh, bt, ct, a, dt, chunk: int):
    """``ssd_chunked`` as the port had it before F8's repair (the
    reference's form): the decay masked after ``exp``."""
    b, s, h, pdim = xh.shape
    n = bt.shape[-1]
    g = s // chunk
    f32 = torch.float32
    xr = xh.reshape(b, g, chunk, h, pdim).to(f32)
    br = bt.reshape(b, g, chunk, n)
    cr = ct.reshape(b, g, chunk, n)
    lar = torch.log(a).reshape(b, g, chunk, h)
    dtr = dt.reshape(b, g, chunk, h)
    cum = torch.cumsum(lar, dim=2)
    total = cum[:, :, -1]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(tri[None, None, :, :, None], torch.exp(rel), 0.0)
    cb = torch.einsum("bgtn,bgsn->bgts", cr, br).to(f32)
    w = cb[..., None] * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bgtsh,bgshp->bgthp", w, xr)
    wstate = torch.exp(total[:, :, None] - cum) * dtr
    sg = torch.einsum("bgsh,bgsn,bgshp->bghnp", wstate, br.to(f32), xr)
    dec_tot = torch.exp(total)
    state = xr.new_zeros(b, h, n, pdim)
    prev = []
    for i in range(g):
        prev.append(state)
        state = state * dec_tot[:, i, :, None, None] + sg[:, i]
    s_prev = torch.stack(prev, dim=1)
    y_inter = torch.einsum("bgtn,bgth,bghnp->bgthp", cr.to(f32), torch.exp(cum),
                           s_prev)
    return (y_intra + y_inter).reshape(b, s, h, pdim), state


def _ssd_inputs(dt_value, seed=0, b=1, s=128, h=8, n=16, p=16):
    """Seeded x, B, C and weights of the outputs; dt = ``dt_value`` (a
    float, or None for softplus of unit normals) with A = 1..16 over the
    heads."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    dt = (torch.full((b, s, h), dt_value) if dt_value is not None
          else torch.nn.functional.softplus(t(b, s, h)))
    leaves = {"xh": t(b, s, h, p), "bt": t(b, s, n), "ct": t(b, s, n), "dt": dt}
    return leaves, torch.linspace(1.0, 16.0, h), t(b, s, h, p), t(b, h, n, p)


def _ssd_grads(fn, leaves, a_rate, gy, gs):
    """(y, state, {leaf: grad}) of sum(y gy) + sum(state gs), a = exp(-dt A)."""
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    xh, bt, ct, dt = (leaves[k] for k in ("xh", "bt", "ct", "dt"))
    y, state = fn(xh, bt, ct, torch.exp(-dt * a_rate), dt)
    ((y * gy).sum() + (state * gs).sum()).backward()
    return y.detach(), state.detach(), {k: v.grad for k, v in leaves.items()}


def test_ssd_chunked_grad_matches_step_scan_where_the_old_form_overflows():
    """dt 0.7 with A up to 16: one step's log-decay reaches -11.2, so the
    old form's exp(rel) overflows above the diagonal and its gradient is
    NaN; the port's is finite and within 1e-5 (relative to each input's
    largest gradient) of the exact step scan's."""
    leaves, a_rate, gy, gs = _ssd_inputs(0.7)
    chunked = lambda *x: PMamba.ssd_chunked(*x, 64)
    steps = lambda xh, bt, ct, a, dt: PMamba.ssd_steps(
        xh, bt, ct, a, dt, torch.zeros(xh.shape[0], xh.shape[2], bt.shape[-1],
                                       xh.shape[-1]))
    _, _, old = _ssd_grads(lambda *x: _ssd_chunked_masked_after_exp(*x, 64), leaves,
                           a_rate, gy, gs)
    assert not all(bool(torch.isfinite(g).all()) for g in old.values())
    y, state, got = _ssd_grads(chunked, leaves, a_rate, gy, gs)
    y_want, state_want, want = _ssd_grads(steps, leaves, a_rate, gy, gs)
    assert torch.allclose(y, y_want, atol=1e-5) and torch.allclose(state, state_want,
                                                                   atol=1e-5)
    for name, g in got.items():
        assert bool(torch.isfinite(g).all()), name
        w = want[name]
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-5, name


@pytest.mark.parametrize("dt_value", [0.7, 0.01, None])
def test_ssd_chunked_forward_is_bit_for_bit_the_old_form(dt_value):
    """The repair moves the mask before exp: exp(-inf) is exactly 0, so
    outputs and final states equal the old form's bit for bit, where it
    overflows (dt 0.7) and where it does not."""
    leaves, a_rate, _, _ = _ssd_inputs(dt_value, seed=3, b=2)
    args = (leaves["xh"], leaves["bt"], leaves["ct"], torch.exp(-leaves["dt"] * a_rate),
            leaves["dt"])
    y, state = PMamba.ssd_chunked(*args, 64)
    y_old, state_old = _ssd_chunked_masked_after_exp(*args, 64)
    assert torch.equal(y, y_old) and torch.equal(state, state_old)


def test_reference_ssd_gradient_is_nan_f8():
    """F8 pinned: zamba2's smoke config with the reference's own init
    (seed 1, B 4, S 128): the reference's loss is finite and its gradient
    NaN; the port's loss is within 1e-5 of it and its gradient finite."""
    ref, params, model = pair("zamba2-2.7b", seed=1)
    bt = make_batch(ref.cfg, 4, S, seed=1)
    (want, _), grads = jax.value_and_grad(ref.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in bt.items()})
    assert np.isfinite(float(want))
    assert sum(int(np.isnan(np.asarray(g)).sum()) for g in jax.tree.leaves(grads)) > 0
    loss, _ = port_loss(model, bt)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
