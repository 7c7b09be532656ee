"""The port's recurrent families on the CPU against the JAX package: rwkv6
(``repro_torch.models.rwkv6``, family "ssm") and zamba2's Mamba2 backbone
with its shared attention block (``repro_torch.models.mamba2``, family
"hybrid").

Inputs come from numpy seeds; parameters from the JAX package's own init,
carried across with ``repro_torch.convert``.  zamba2's LoRA ``b`` starts
at zeros in the reference's init, which would leave the adapters out of
every product, so the model tests draw it from a numpy seed.  Tolerances:

* modules in float32 (``time_mix`` with its carried state, on the exact
  scan at S = 17 and the chunked form at S = 64 and 96; ``mamba2_forward``
  with its ssm/conv state, on the step scan at S = 17 and the chunked form
  at S = 64 and 128): 1e-5 absolute on values of order 1;
* whole models in float32 (forward logits, prefill logits and every cache
  leaf, decode steps), at prompt lengths that take the chunked forms (64)
  and the step scans (17): 1e-5 absolute;
* whole models in bfloat16 (at S = 64): 2.5e-2 absolute on logits of order 0.5 and
  on the cache leaves (with the same relative term), a few bf16 ulps: the
  recurrences add bf16 roundings of every projection at every layer to the
  dense models' (1.5e-2), and the largest difference seen over these
  cases is 1.7e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as RMamba
import repro.models.rwkv6 as RRwkv
from repro.configs import get_smoke as r_get_smoke
from repro.models.config import SSMConfig as RSSMConfig
from repro.models.model import CausalLM as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as REngine
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash
from repro_torch.kernels.flash import flash_attention
from repro_torch.launch import serve as launcher
from repro_torch.models import mamba2 as PMamba
from repro_torch.models import rwkv6 as PRwkv
from repro_torch.models.config import SSMConfig
from repro_torch.models.model import CausalLM
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("rwkv6-3b", "zamba2-2.7b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _tp(p):
    return {k: _t(v) for k, v in p.items()}


# --------------------------------------------------------------------------
# rwkv6 time mix and channel mix
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [17, 64, 96])
def test_time_mix_matches_reference(s):
    """From a carried state and token-shift input; S = 17 runs the exact
    scan, 64 and 96 the chunked form."""
    b, h, kd = 2, 3, 16
    d = h * kd
    p = RRwkv.init_rwkv_block(jax.random.PRNGKey(0), d, 4 * d, kd)["tmix"]
    rng = np.random.default_rng(s)
    x = (0.5 * rng.standard_normal((b, s, d))).astype(np.float32)
    state = (0.1 * rng.standard_normal((b, h, kd, kd))).astype(np.float32)
    x_prev = rng.standard_normal((b, d)).astype(np.float32)
    want, (want_state, want_last) = jax.jit(RRwkv.time_mix, static_argnums=2)(
        p, jnp.asarray(x), kd, jnp.asarray(state), jnp.asarray(x_prev))
    got, (got_state, got_last) = PRwkv.time_mix(_tp(p), _t(x), kd, _t(state), _t(x_prev))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_state.numpy(), _np(want_state), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_last.numpy(), _np(want_last))
    assert (s > PRwkv.WKV_CHUNK and s % PRwkv.WKV_CHUNK == 0) == (s != 17)


def test_channel_mix_matches_reference():
    d = 32
    p = RRwkv.init_rwkv_block(jax.random.PRNGKey(1), d, 80, 16)["cmix"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    x_prev = rng.standard_normal((2, d)).astype(np.float32)
    want, want_last = jax.jit(RRwkv.channel_mix)(p, jnp.asarray(x), jnp.asarray(x_prev))
    got, got_last = PRwkv.channel_mix(_tp(p), _t(x), _t(x_prev))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_last.numpy(), _np(want_last))


def test_wkv_chunked_matches_exact_scan():
    """The port's chunked form against its own exact scan at 1e-5
    relative (the reference's tolerance in tests/test_rwkv_chunked.py),
    from a carried state."""
    rng = np.random.default_rng(3)
    b, s, h, kd = 2, 96, 3, 16
    r, k, v = (torch.tensor(rng.standard_normal((b, s, h, kd)), dtype=torch.float32)
               for _ in range(3))
    w = torch.tensor(rng.uniform(0.6, 0.99, (b, s, h, kd)), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal((h, kd)), dtype=torch.float32)
    s0 = torch.tensor(rng.standard_normal((b, h, kd, kd)), dtype=torch.float32)
    o1, st1 = PRwkv.wkv6_chunked(r, k, v, w, u, s0)
    o2, st2 = PRwkv.wkv6_steps(r, k, v, w, u, s0)
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st1, st2, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------
MCFG = dict(head_dim=8, d_state=16, d_conv=4, expand=2, chunk=32, kind="mamba2")


@pytest.mark.parametrize("s,mode", [(17, "carry"), (1, "carry"), (64, "final"),
                                    (128, "final"), (64, None)])
def test_mamba2_forward_matches_reference(s, mode):
    """From a carried state (S = 17, and S = 1 as decode) the step scan
    runs; from none at 64 and 128 (multiples of the chunk) the chunked
    form, returning its final state as prefill does, or no state."""
    d = 32
    rcfg = RSSMConfig(**MCFG)
    p = RMamba.init_mamba2(jax.random.PRNGKey(4), d, rcfg)
    rng = np.random.default_rng(s)
    p = dict(p, dt_bias=jnp.asarray(rng.standard_normal(p["dt_bias"].shape),
                                    jnp.float32),
             conv_b=jnp.asarray(0.1 * rng.standard_normal(p["conv_b"].shape),
                                jnp.float32))
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    nh = 2 * d // 8
    state = mode
    if mode == "carry":
        state = {"ssm": (0.1 * rng.standard_normal((2, nh, 16, 8))).astype(np.float32),
                 "conv": rng.standard_normal((2, 3, 2 * d + 32)).astype(np.float32)}
    carried = jax.tree.map(jnp.asarray, state) if isinstance(state, dict) else None
    want, want_state = jax.jit(lambda p, x, st: RMamba.mamba2_forward(
        p, x, rcfg, d, st if isinstance(state, dict) else state))(p, jnp.asarray(x), carried)
    got, got_state = PMamba.mamba2_forward(
        _tp(p), _t(x), SSMConfig(**MCFG), d,
        jax.tree.map(_t, state) if isinstance(state, dict) else state)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    if want_state is None:
        assert got_state is None
    else:
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(got_state[name].numpy(), _np(want_state[name]),
                                       atol=1e-5, rtol=0, err_msg=name)


# --------------------------------------------------------------------------
# whole models: forward, prefill + cache, decode
# --------------------------------------------------------------------------
B, DECODE = 2, 4
TOL = {"float32": 1e-5, "bfloat16": 2.5e-2}


def _params(cfg, seed):
    params = RModel(cfg).init(jax.random.PRNGKey(seed))
    if cfg.family == "hybrid":          # adapters that change q/k/v
        rng = np.random.default_rng(seed)
        params["stack"]["lora"] = jax.tree.map(
            lambda a: jnp.asarray(0.02 * rng.standard_normal(a.shape), a.dtype),
            params["stack"]["lora"])
    return params


def _run_reference(cfg, params, tokens, max_len):
    model = RModel(cfg)
    batch = {"tokens": jnp.asarray(tokens)}
    logits, _ = jax.jit(model.forward)(params, batch)
    pre, cache = jax.jit(model.prefill, static_argnums=(2,),
                         static_argnames=("cache_dtype",))(
        params, batch, max_len, cache_dtype=jnp.float32)
    caches = [jax.tree.map(np.asarray, cache)]
    decode = jax.jit(model.decode_step)
    s = tokens.shape[1]
    steps, tok = [], jnp.argmax(pre[:, -1], -1)[:, None].astype(jnp.int32)
    for i in range(DECODE):
        lg, cache = decode(params, tok, cache, jnp.asarray(s + i, jnp.int32))
        steps.append((np.asarray(tok), _np(lg)))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    caches.append(jax.tree.map(np.asarray, cache))
    return _np(logits), _np(pre), caches, steps


def _assert_cache_close(cache, want, tol):
    got = convert.lm_cache_to_reference(cache)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("s,dtype", [(64, "float32"), (17, "float32"),
                                     (64, "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, s, dtype):
    """S = 64 takes rwkv6's and Mamba2's chunked forms in forward and
    prefill, S = 17 their step scans; decode always steps."""
    cfg = dataclasses.replace(r_get_smoke(arch), dtype=dtype)
    params = _params(cfg, 7)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    max_len = s + 8
    want_fwd, want_pre, want_caches, want_steps = _run_reference(cfg, params, tokens,
                                                                 max_len)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                             device="cpu")
    tol = TOL[dtype]
    logits, aux = model(torch.as_tensor(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), want_fwd, atol=tol, rtol=0)
    pre, cache = model.prefill(torch.as_tensor(tokens), max_len, cache_dtype=torch.float32)
    np.testing.assert_allclose(pre.numpy(), want_pre, atol=tol, rtol=0)
    _assert_cache_close(cache, want_caches[0], tol)
    for i, (tok, want) in enumerate(want_steps):
        lg, cache = model.decode_step(torch.tensor(tok), cache, s + i)
        np.testing.assert_allclose(lg.numpy(), want, atol=tol, rtol=0)
    _assert_cache_close(cache, want_caches[1], tol)


def test_zamba2_lora_changes_the_shared_block():
    """With the reference's zero ``b`` the adapters add nothing; with drawn
    ones every invocation's q/k/v move, and the port follows (the model
    test above holds the values)."""
    cfg = dataclasses.replace(r_get_smoke("zamba2-2.7b"), dtype="float32")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (1, 12)))
    out = []
    for params in (RModel(cfg).init(jax.random.PRNGKey(1)), _params(cfg, 1)):
        model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                                 device="cpu")
        out.append(model(tokens)[0])
    assert float((out[0] - out[1]).abs().max()) > 1e-4


def test_prefill_attends_through_k3_once_per_group(monkeypatch):
    """zamba2's shared block reaches K3's wrapper once per group in
    prefill (hd 16 on the smoke, 80 at full width); rwkv6 never."""
    seen = []

    def recording(q, k, v, **kw):
        seen.append(q.shape[-1])
        return flash.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(flash, "flash_attention", recording)
    for arch, want in (("zamba2-2.7b", 2), ("rwkv6-3b", 0)):
        seen.clear()
        model = CausalLM(get_smoke(arch), device="cpu", seed=0)
        model.prefill(torch.zeros(1, 10, dtype=torch.int64), 16)
        assert len(seen) == want
        seen.clear()
        model.decode_step(torch.zeros(1, 1, dtype=torch.int64), model.init_cache(1, 16), 3)
        assert seen == []
    assert 80 in flash.HEAD_DIMS


# --------------------------------------------------------------------------
# the serving engine, convert, the launcher
# --------------------------------------------------------------------------
PROMPTS = [(11, 5), (7, 3), (9, 4)]   # (prompt length, new tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    cfg = dataclasses.replace(r_get_smoke(arch), dtype="float32")
    params = _params(cfg, 2)
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
    params = jax.tree.map(np.asarray, _params(cfg, 3))
    model = convert.lm_params_from_reference(params, cfg, device="cpu")
    back = convert.lm_params_to_reference(model)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert model.param_count() == rmodel.param_count(params)
    # a cache tree both ways (zamba2's nests its attention k/v)
    rng = np.random.default_rng(4)
    ref_cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                             jax.tree.map(np.asarray, rmodel.init_cache(2, 24, jnp.float32)))
    port = convert.lm_cache_from_reference(ref_cache, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == \
        jax.tree.map(lambda t: tuple(t.shape), model.init_cache(2, 24))
    back = convert.lm_cache_to_reference(port)
    assert jax.tree.all(jax.tree.map(lambda a, b: a.tobytes() == b.tobytes(),
                                     back, ref_cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_shapes(arch):
    """The port's own init: the reference's shapes, scales and constants."""
    model = CausalLM(get_smoke(arch), device="cpu", seed=0)
    ref = convert.lm_params_to_reference(model)
    want = RModel(r_get_smoke(arch)).init(jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, want)
    stack, rstack = ref["stack"], jax.tree.map(np.asarray, want["stack"])
    if arch == "rwkv6-3b":
        tmix, rtmix = stack["layers"]["block"]["tmix"], rstack["layers"]["block"]["tmix"]
        for name in ("mix", "w0", "ln_scale"):
            np.testing.assert_array_equal(tmix[name], rtmix[name])
        assert abs(float(np.std(tmix["wb"])) - 0.002) < 3e-4
    else:
        m, rm = stack["mamba"]["ssm"], rstack["mamba"]["ssm"]
        for name in ("a_log", "dt_bias", "d_skip", "conv_b", "norm_scale"):
            np.testing.assert_allclose(m[name], rm[name], rtol=2.4e-7, atol=0)  # 2 ulps
        assert abs(float(np.std(m["conv_w"])) - 0.2) < 2e-2
        assert not stack["lora"]["q"]["b"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_smoke_on_cpu(arch, capsys):
    flash_attention.launches = 0
    finished = launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--slots", "2", "--prompt-len", "12",
                              "--max-new", "3", "--max-len", "24"])
    out = capsys.readouterr().out
    assert len(finished) == 3 and all(len(r.out_tokens) == 3 for r in finished)
    assert f"{arch}-smoke" in out and "K3 flash_attention launches: 0" in out
