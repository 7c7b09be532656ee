"""The port's LM stack on the CPU against the JAX package.

Inputs come from numpy seeds; parameters from the JAX ``CausalLM.init``,
carried across with ``repro_torch.convert``.  JAX runs on the CPU, its
Pallas kernel K3 in interpret mode.  Tolerances:

* layers and MLP, float32: 1e-6 absolute on values of order 1;
* ``flash_attention_ref`` against the interpreted Pallas K3 and against
  ``_attend_dense``, float32: 2e-5 (the test the JAX package holds its own
  kernel to); bfloat16: one bf16 rounding of outputs of order 1, 2e-2;
* K3's own bf16 tolerance on the card (``kernels.flash.error_bound``) is
  itself tested here: it admits K3's rounding and rejects emulated faults;
* whole models in float32 (forward logits, prefill logits and cache, four
  decode steps): 1e-5 absolute.  K3 keeps q*scale and p in float32 where
  the reference's dense path rounds them to the compute dtype; in float32
  the two agree to ~1e-7 on these logits;
* whole models in bfloat16: 1.5e-2 absolute on logits below 1 in
  magnitude, about four bf16 ulps there (the largest difference seen over
  the four configs is 5.9e-3: the logits are rounded to bf16 before the
  float32 cast, and the two packages take other roundings at different
  places, K3's float32 probabilities among them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.kernels.flash import flash_attention as r_flash
from repro.models import layers as RL
from repro.models import mlp as RM
from repro.models.model import CausalLM as RModel
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.kernels.flash import error_bound, flash_attention, flash_attention_ref
from repro_torch.models import layers as PL
from repro_torch.models import mlp as PM
from repro_torch.models.attention import AttnConfig, _attend_dense

DENSE = ("starcoder2-3b", "chatglm3-6b", "qwen1.5-32b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_the_reference(arch):
    assert ARCHS == R_ARCHS
    for mine, ref in ((get_config(arch), r_get_config(arch)),
                      (get_smoke(arch), r_get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.hd == ref.hd
        assert mine.param_count() == ref.param_count()


# --------------------------------------------------------------------------
# (a) layers and MLP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches(plus_one):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    want = _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, plus_one))
    got = PL.rms_norm(_t(x), _t(w), 1e-5, plus_one).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches(fraction):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 100, (2, 7)).astype(np.int32)
    want = _np(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction, 10000.0))
    got = PL.apply_rope(_t(x), torch.as_tensor(pos), fraction, 10000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert PL.rope_frequencies(32, fraction, 1e4)[0] == RL.rope_frequencies(32, fraction, 1e4)[0]


@pytest.mark.parametrize("kind", PM.KINDS)
def test_mlp_matches(kind):
    rng = np.random.default_rng(3)
    p = RM.init_mlp(jax.random.PRNGKey(0), 32, 80, kind)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = _np(RM.mlp(p, jnp.asarray(x), kind))
    got = PM.mlp({k: _t(v) for k, v in p.items()}, _t(x), kind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# (b) the plain version of K3
# --------------------------------------------------------------------------
def _qkv(seed, b, s, t, kvh, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, kvh * g, hd)).astype(np.float32),
            rng.standard_normal((b, t, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, t, kvh, hd)).astype(np.float32))


@pytest.mark.parametrize("s,kvh,g,hd,softcap,bq,bk,causal", [
    (128, 2, 2, 16, None, 32, 32, True),
    (128, 1, 4, 8, 30.0, 64, 32, True),
    (256, 2, 1, 16, None, 64, 64, True),
    (64, 4, 2, 8, None, 64, 64, True),      # single q block
    (64, 1, 2, 8, None, 32, 32, False),
])
def test_flash_ref_matches_pallas_kernel(s, kvh, g, hd, softcap, bq, bk, causal):
    q, k, v = _qkv(s + hd, 2, s, s, kvh, g, hd)
    want = _np(r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       softcap=softcap, causal=causal, bq=bq, bk=bk,
                       interpret=True))
    got = flash_attention_ref(_t(q), _t(k), _t(v), softcap=softcap,
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_flash_ref_matches_pallas_kernel_bf16():
    q, k, v = _qkv(0, 1, 128, 128, 2, 2, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = _np(r_flash(jq, jk, jv, bq=64, bk=64, interpret=True))
    got = flash_attention_ref(*(_t(_np(a), torch.bfloat16) for a in (jq, jk, jv)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("s,softcap", [(50, None), (37, 20.0)])
def test_flash_ref_matches_attend_dense_at_ragged_lengths(s, softcap):
    """Lengths that are no multiple of a block (the Pallas kernel asserts
    divisibility; the port takes any length)."""
    q, k, v = _qkv(s, 2, s, s, 2, 3, 16)
    cfg = RA.AttnConfig(d_model=1, n_heads=6, n_kv_heads=2, head_dim=16,
                        softcap=softcap)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = _np(RA._attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                cfg, pos, pos))
    got = flash_attention_ref(_t(q), _t(k), _t(v), softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # the port's own dense path (decode's) agrees too
    pcfg = AttnConfig(d_model=1, n_heads=6, n_kv_heads=2, head_dim=16,
                      softcap=softcap)
    ppos = torch.arange(s)
    dense = _attend_dense(_t(q), _t(k), _t(v), pcfg, ppos, ppos).numpy()
    np.testing.assert_allclose(dense, want, atol=2e-5, rtol=0)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits, to nearest)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("fault", [None, "tf32_p", "bf16_p", "drop_diagonal",
                                   "no_rescale"])
def test_k3_error_bound_admits_its_numerics_and_rejects_late_row_faults(fault):
    """K3's bf16 tolerance against its plain version: an output with K3's
    own rounding (the unnormalised p rounded to bfloat16 before p.v, the
    row sum l kept in float32; or the older kernel's TF32 p) lies within it
    at every element; faults on the last q block only (its diagonal key
    tile dropped, or the running sum not rescaled when the max grows) do
    not."""
    s, bq = 256, 64
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(7, 1, s, s, 2, 2, 64))
    want = flash_attention_ref(q, k, v)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    logits = qf @ kf.repeat_interleave(2, 1).transpose(-1, -2) / 8.0
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None]
    visible = cols <= rows
    if fault == "drop_diagonal":
        visible = visible & ~((rows >= s - bq) & (cols >= s - bq))
    p = torch.softmax(logits.masked_fill(~visible, -1e30), -1)
    if fault == "no_rescale":   # last block: terms before its diagonal tile
        m_all = logits.masked_fill(~visible, -1e30).amax(-1, keepdim=True)
        m_old = logits[..., : s - bq].amax(-1, keepdim=True)
        e = torch.exp(logits - torch.where(cols < s - bq, m_old, m_all))
        e = e.masked_fill(~visible, 0.0)
        p = torch.where(rows >= s - bq, e / e.sum(-1, keepdim=True), p)
    if fault == "tf32_p":
        p = _tf32(p)
    if fault == "bf16_p":
        e = torch.exp(logits - logits.amax(-1, keepdim=True)).masked_fill(~visible, 0.0)
        p = e.bfloat16().float() / e.sum(-1, keepdim=True)
    got = (p @ vf.repeat_interleave(2, 1)).transpose(1, 2).bfloat16()
    within = (got.float() - want.float()).abs() <= error_bound(q, k, v, want)
    admitted = (None, "tf32_p", "bf16_p")
    assert bool(within.all()) == (fault in admitted)
    if fault not in admitted:
        assert bool(within[:, : s - bq].all())      # the fault is late rows only


def test_flash_wrapper_on_cpu_tensors_launches_nothing():
    q, k, v = (_t(a) for a in _qkv(4, 1, 9, 9, 1, 2, 8))
    flash_attention.launches = 0
    out = flash_attention(q, k, v, softcap=5.0)
    assert flash_attention.launches == 0
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, softcap=5.0),
                               rtol=0, atol=0)


# --------------------------------------------------------------------------
# (c) whole models: forward, prefill + cache, decode
# --------------------------------------------------------------------------
def _gemma_like_global():
    """gemma2's smoke config with global layers only: post-norms, embedding
    scale, attention and final softcaps, query scale and head_dim 32 — the
    dense-global options the three dense archs leave unused."""
    return dataclasses.replace(r_get_smoke("gemma2-2b"), name="gemma2-global-smoke",
                               layer_pattern="global", local_window=None)


MODELS = [pytest.param(lambda a=a: r_get_smoke(a), id=a) for a in DENSE] + [
    pytest.param(_gemma_like_global, id="gemma2-global")]
B, S, MAX_LEN, DECODE = 2, 12, 20, 4
TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}


def _run_reference(cfg, params, tokens):
    model = RModel(cfg)
    logits, _ = jax.jit(model.forward)(params, {"tokens": tokens})
    pre, cache = jax.jit(model.prefill, static_argnums=(2,), static_argnames=("cache_dtype",))(
        params, {"tokens": tokens}, MAX_LEN, cache_dtype=jnp.float32)
    caches = [jax.tree.map(np.asarray, cache)]
    decode = jax.jit(model.decode_step)
    steps, tok = [], jnp.argmax(pre[:, -1], -1)[:, None].astype(jnp.int32)
    for i in range(DECODE):
        lg, cache = decode(params, tok, cache, jnp.asarray(S + i, jnp.int32))
        steps.append((np.asarray(tok), _np(lg)))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    caches.append(jax.tree.map(np.asarray, cache))
    return _np(logits), _np(pre), caches, steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("make_cfg", MODELS)
def test_model_matches_reference(make_cfg, dtype):
    cfg = dataclasses.replace(make_cfg(), dtype=dtype)
    params = RModel(cfg).init(jax.random.PRNGKey(7))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want_fwd, want_pre, want_caches, want_steps = _run_reference(
        cfg, params, jnp.asarray(tokens))

    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             cfg, device="cpu")
    tol = TOL[dtype]
    logits, aux = model(torch.as_tensor(tokens))
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), want_fwd, atol=tol, rtol=0)
    pre, cache = model.prefill(torch.as_tensor(tokens), MAX_LEN,
                               cache_dtype=torch.float32)
    np.testing.assert_allclose(pre.numpy(), want_pre, atol=tol, rtol=0)
    _assert_cache_close(cache, want_caches[0], tol)
    for i, (tok, want) in enumerate(want_steps):
        lg, cache = model.decode_step(torch.tensor(tok), cache, S + i)
        np.testing.assert_allclose(lg.numpy(), want, atol=tol, rtol=0)
    _assert_cache_close(cache, want_caches[1], tol)


def _assert_cache_close(cache, want, tol):
    got = convert.lm_cache_to_reference(cache)
    for name in ("k", "v"):
        np.testing.assert_allclose(got["layers"][name], want["layers"][name],
                                   atol=tol, rtol=tol)


def test_prefill_cache_matches_reference_exactly_in_float32():
    """Before any decode step the port's prefill cache is the reference's
    (zeros past the prompt included)."""
    cfg = dataclasses.replace(r_get_smoke("qwen1.5-32b"), dtype="float32")
    params = RModel(cfg).init(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    _, want = RModel(cfg).prefill(params, {"tokens": jnp.asarray(tokens)}, 16,
                                  cache_dtype=jnp.float32)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                             device="cpu")
    _, cache = model.prefill(torch.as_tensor(tokens), 16, cache_dtype=torch.float32)
    got = convert.lm_cache_to_reference(cache)
    for name in ("k", "v"):
        np.testing.assert_allclose(got["layers"][name], np.asarray(want["layers"][name]),
                                   atol=1e-6, rtol=0)
        assert not got["layers"][name][:, :, 9:].any()
    # a reference cache carried in decodes like the port's own
    carried = convert.lm_cache_from_reference(jax.tree.map(np.asarray, want),
                                              device="cpu")
    tok = torch.tensor([[3]])
    a, _ = model.decode_step(tok, carried, 9)
    b, _ = model.decode_step(tok, cache, 9)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# (e) convert round trip
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_convert_round_trip_is_byte_equal(arch):
    cfg = r_get_smoke(arch)
    params = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(3)))
    model = convert.lm_params_from_reference(params, cfg, device="cpu")
    back = convert.lm_params_to_reference(model)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert model.param_count() == RModel(cfg).param_count(params)


def test_convert_rejects_mismatched_params():
    cfg = r_get_smoke("starcoder2-3b")
    params = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(0)))
    params["stack"]["layers"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        convert.lm_params_from_reference(params, cfg, device="cpu")
    del params["stack"]["layers"]["extra"]
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_reference(params, dataclasses.replace(cfg, d_ff=96),
                                         device="cpu")


def test_convert_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = {"layers": {n: np.zeros((1, 1, 4, 1, 8), np.float32) for n in ("k", "v")}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.lm_params_from_reference({}, r_get_smoke("starcoder2-3b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.lm_cache_from_reference(cache)
    on_cpu = convert.lm_cache_from_reference(cache, device="cpu")
    assert on_cpu["layers"]["k"].device.type == "cpu"
