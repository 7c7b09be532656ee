"""The port's MoE family (deepseek-moe-16b, moonshot-v1-16b-a3b) on the CPU
against the JAX package.

Inputs come from numpy seeds; parameters from the JAX package's own init,
carried across with ``repro_torch.convert``.  Tolerances:

* routing and dispatch: integer-equal (expert ids, destinations, keep
  mask), the routing weights within 3e-7 (float32 weights below 1: a few
  ulps, the two softmaxes and sums round differently);
* ``moe_ffn`` in float32: 1e-5 absolute on outputs of order 0.1 (the two
  sum in another order), the aux loss within 1e-6; in bfloat16 on the same
  bf16 input: 2**-6 of the largest output, a few bf16 ulps (both round the
  expert products and the weighted combine to bf16, not always at the same
  places);
* whole models in float32 (forward logits, prefill logits and every cache
  leaf, decode steps): 1e-5 absolute.  In bfloat16 top-k routing is
  discontinuous: a rounding that moves a token's k-th and (k+1)-th router
  probabilities past each other sends it to another expert, and at a
  capacity that drops, shifts which later tokens are dropped, so such a
  token's logits differ by far more than rounding (up to 6e-2 on these
  smokes), and its k/v carry the change into the rows after it.  The bf16
  check is that three quarters of the token rows (forward, prefill and
  decode together) lie within the dense models' 1.5e-2 and every row
  within 1e-1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models import moe as RMoE
from repro.models.config import MoEConfig as RMoEConfig
from repro.models.model import CausalLM as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as REngine
from repro_torch import convert
from repro_torch.kernels import flash
from repro_torch.kernels.flash import flash_attention
from repro_torch.launch import serve as launcher
from repro_torch.models import moe as PMoE
from repro_torch.models.config import MoEConfig
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens_router(seed, n, d, e):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (0.3 * rng.standard_normal((d, e))).astype(np.float32))


# --------------------------------------------------------------------------
# routing and dispatch on JAX's own routing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("capacity_factor,drops", [(1.0, True), (8.0, False)])
def test_dispatch_matches_reference(capacity_factor, drops):
    """Given JAX's own top-k, the port's destinations and keep mask are
    the reference's: ``_pack_by`` (the sort-based packing moe_ffn runs)
    gives each (token, choice) pair its slot or -1 when dropped."""
    e, k, n = 8, 2, 96
    cfg = RMoEConfig(n_experts=e, top_k=k, capacity_factor=capacity_factor)
    tokens, router = _tokens_router(0, n, 16, e)
    probs = jax.nn.softmax(jnp.asarray(tokens) @ jnp.asarray(router), axis=-1)
    top_w, top_e = jax.lax.top_k(probs, k)
    flat_e = np.asarray(top_e).reshape(-1)
    cap = max(8, int(cfg.capacity_factor * n * k / e + 0.999))
    assert PMoE.capacity(MoEConfig(**dataclasses.asdict(cfg)), n) == cap
    _, want_slot = RMoE._pack_by(jnp.asarray(flat_e), jnp.zeros((n * k, 1)), e, cap)

    order, dest, keep = PMoE.dispatch(torch.as_tensor(flat_e.copy()), e, cap)
    slot = torch.full((n * k,), -1, dtype=torch.int64)
    slot[order] = torch.where(keep, dest, -1)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    assert bool((dest[keep] < e * cap).all()) and bool((dest[~keep] == e * cap).all())
    assert bool((~keep).any()) == drops

    # the port's routing of the same tokens: the same experts and weights
    _, got_w, got_e = PMoE.route(torch.as_tensor(router), torch.as_tensor(tokens),
                                 MoEConfig(n_experts=e, top_k=k))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(top_e))
    want_w = np.asarray(top_w / jnp.sum(top_w, axis=-1, keepdims=True))
    np.testing.assert_allclose(got_w.numpy(), want_w, atol=3e-7, rtol=0)


def _moe_inputs(kind, n_shared, capacity_factor, seed=0):
    cfg = RMoEConfig(n_experts=8, top_k=3, n_shared=n_shared,
                     capacity_factor=capacity_factor)
    p = RMoE.init_moe(jax.random.PRNGKey(seed), 32, 48, cfg, kind)
    # a router of the scale a trained one has, so that the choices differ
    p["router"] = p["router"] * 50.0
    x = np.random.default_rng(seed + 1).standard_normal((2, 21, 32)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("kind,n_shared,capacity_factor", [
    ("swiglu", 2, 1.0), ("swiglu", 2, 8.0), ("geglu", 1, 1.0), ("gelu", 0, 1.0)])
def test_moe_ffn_matches_reference(kind, n_shared, capacity_factor):
    """At capacity factor 1 some (token, choice) pairs overflow: they must
    contribute exactly nothing, as in the reference."""
    cfg, p, x = _moe_inputs(kind, n_shared, capacity_factor)
    want, want_aux = jax.jit(RMoE.moe_ffn, static_argnums=(2, 3))(p, jnp.asarray(x), cfg,
                                                                   kind)
    mine = MoEConfig(**dataclasses.asdict(cfg))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    got, aux = PMoE.moe_ffn(tp, torch.as_tensor(x), mine, kind)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    # one rank's MoE layer (its module, as a block runs it) is moe_ffn
    layer = PMoE.MoE(x.shape[-1], p["up"].shape[-1], mine, kind)
    with torch.no_grad():
        for k, v in tp.items():
            (layer.experts if k in ("up", "gate", "down") else layer)._parameters[k].copy_(v)
    one, one_aux = layer(torch.as_tensor(x))
    assert torch.equal(one, got) and torch.equal(one_aux, aux)
    tokens = torch.as_tensor(x).reshape(-1, x.shape[-1])
    _, _, top_e = PMoE.route(tp["router"], tokens, mine)
    _, _, keep = PMoE.dispatch(top_e.reshape(-1), mine.n_experts,
                               PMoE.capacity(mine, tokens.shape[0]))
    assert bool(keep.all()) == (capacity_factor > 2)


def test_moe_ffn_bf16_matches_reference():
    cfg, p, x = _moe_inputs("swiglu", 2, 1.25, seed=3)
    xj = jnp.asarray(x, jnp.bfloat16)
    want, _ = jax.jit(RMoE.moe_ffn, static_argnums=(2, 3))(p, xj, cfg, "swiglu")
    tp = {k: torch.as_tensor(np.array(v)).bfloat16() for k, v in p.items()}
    tp["router"] = torch.as_tensor(np.array(p["router"]))       # read in float32
    got, _ = PMoE.moe_ffn(tp, torch.tensor(_np(xj)).bfloat16(),
                          MoEConfig(**dataclasses.asdict(cfg)), "swiglu")
    assert got.dtype == torch.bfloat16
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -6 * np.abs(want).max(), rtol=0)


# --------------------------------------------------------------------------
# whole models: forward, prefill + cache, decode
# --------------------------------------------------------------------------
B, MAX_LEN, DECODE = 2, 32, 4


def _run_reference(cfg, params, tokens):
    model = RModel(cfg)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, aux = jax.jit(model.forward)(params, batch)
    pre, cache = jax.jit(model.prefill, static_argnums=(2,),
                         static_argnames=("cache_dtype",))(
        params, batch, MAX_LEN, cache_dtype=jnp.float32)
    caches = [jax.tree.map(np.asarray, cache)]
    decode = jax.jit(model.decode_step)
    s = tokens.shape[1]
    steps, tok = [], jnp.argmax(pre[:, -1], -1)[:, None].astype(jnp.int32)
    for i in range(DECODE):
        lg, cache = decode(params, tok, cache, jnp.asarray(s + i, jnp.int32))
        steps.append((np.asarray(tok), _np(lg)))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    caches.append(jax.tree.map(np.asarray, cache))
    return _np(logits), float(aux), _np(pre), caches, steps


def _row_errors(got, want, dtype, what):
    """Largest |got - want| per token row; float32 is held to 1e-5 here."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=what)
    return np.abs(got - want).reshape(-1, got.shape[-1]).max(-1)


def _assert_cache_close(cache, want, tol):
    got = convert.lm_cache_to_reference(cache)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, dtype):
    """17 tokens x 2 rows: moonshot's smoke capacity drops tokens, so the
    dispatch's overflow path runs inside the model too."""
    cfg = dataclasses.replace(r_get_smoke(arch), dtype=dtype)
    params = RModel(cfg).init(jax.random.PRNGKey(7))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 17)).astype(np.int32)
    want_fwd, want_aux, want_pre, want_caches, want_steps = _run_reference(
        cfg, params, tokens)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                             device="cpu")
    logits, aux = model(torch.as_tensor(tokens))
    rows = [_row_errors(logits.numpy(), want_fwd, dtype, "forward")]
    assert abs(float(aux) - want_aux) <= (1e-6 if dtype == "float32" else 1e-4)
    assert float(aux) > 0
    pre, cache = model.prefill(torch.as_tensor(tokens), MAX_LEN, cache_dtype=torch.float32)
    rows.append(_row_errors(pre.numpy(), want_pre, dtype, "prefill"))
    if dtype == "float32":
        _assert_cache_close(cache, want_caches[0], 1e-5)
    for i, (tok, want) in enumerate(want_steps):
        lg, cache = model.decode_step(torch.tensor(tok), cache, 17 + i)
        rows.append(_row_errors(lg.numpy(), want, dtype, f"decode {i}"))
    if dtype == "float32":
        _assert_cache_close(cache, want_caches[1], 1e-5)
    else:   # every row of forward, prefill and decode together
        rows = np.concatenate(rows)
        assert (rows <= 1.5e-2).mean() >= 0.75 and rows.max() <= 1e-1, rows


# --------------------------------------------------------------------------
# the serving engine, convert, the launcher
# --------------------------------------------------------------------------
PROMPTS = [(11, 5), (7, 3), (9, 4)]   # (prompt length, new tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    cfg = dataclasses.replace(r_get_smoke(arch), dtype="float32")
    params = RModel(cfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(9)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
               for n, new in PROMPTS]
    ref = REngine(RModel(cfg), params, 2, 32)
    for i, (p, new) in enumerate(prompts):
        ref.submit(RRequest(rid=i, prompt=p, max_new_tokens=new))
    ref_out = {r.rid: r.out_tokens for r in ref.run()}

    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                             device="cpu")
    eng = ServeEngine(model, 2, 32)
    for i, (p, new) in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    out = {r.rid: r.out_tokens for r in eng.run()}
    assert out == ref_out
    assert [len(out[i]) for i in range(3)] == [new for _, new in PROMPTS]
    _assert_cache_close(eng.cache, ref.cache, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_byte_equal(arch):
    cfg = r_get_smoke(arch)
    rmodel = RModel(cfg)
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(3)))
    model = convert.lm_params_from_reference(params, cfg, device="cpu")
    back = convert.lm_params_to_reference(model)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert model.param_count() == rmodel.param_count(params)
    assert len(model.layers["dense_layers"]) == cfg.first_dense
    assert len(model.layers["moe_layers"]) == cfg.n_layers - cfg.first_dense
    # a cache tree both ways
    rng = np.random.default_rng(4)
    ref_cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                             jax.tree.map(np.asarray, rmodel.init_cache(2, 24, jnp.float32)))
    port = convert.lm_cache_from_reference(ref_cache, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == \
        jax.tree.map(lambda t: tuple(t.shape), model.init_cache(2, 24))
    back = convert.lm_cache_to_reference(port)
    assert jax.tree.all(jax.tree.map(lambda a, b: a.tobytes() == b.tobytes(),
                                     back, ref_cache))


def test_port_init_matches_reference_shapes():
    """The port's own init: the reference's shapes, scales and constants."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import CausalLM

    model = CausalLM(get_smoke("deepseek-moe-16b"), device="cpu", seed=0)
    ref = convert.lm_params_to_reference(model)
    want = RModel(r_get_smoke("deepseek-moe-16b")).init(jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, want)
    moe = ref["stack"]["moe_layers"]["moe"]
    assert abs(float(np.std(moe["router"])) - 0.006) < 1e-3
    assert abs(float(np.std(moe["up"])) - 0.02) < 2e-3
    assert (ref["stack"]["moe_layers"]["norm_mlp"] == 1).all()


def test_prefill_attends_through_k3_once_per_layer(monkeypatch):
    seen = []

    def recording(q, k, v, **kw):
        seen.append(q.shape)
        return flash.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(flash, "flash_attention", recording)
    cfg = r_get_smoke("deepseek-moe-16b")
    params = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(0)))
    model = convert.lm_params_from_reference(params, cfg, device="cpu")
    model.prefill(torch.zeros(1, 10, dtype=torch.int64), 16)
    assert len(seen) == cfg.n_layers
    seen.clear()
    model.decode_step(torch.zeros(1, 1, dtype=torch.int64), model.init_cache(1, 16), 3)
    assert seen == []


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_smoke_on_cpu(arch, capsys):
    flash_attention.launches = 0
    finished = launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--slots", "2", "--prompt-len", "12",
                              "--max-new", "3", "--max-len", "24"])
    out = capsys.readouterr().out
    assert len(finished) == 3 and all(len(r.out_tokens) == 3 for r in finished)
    assert f"{arch}-smoke" in out and "K3 flash_attention launches: 0" in out
