"""gemma2's local/global pairs and paligemma's prefix-LM mask in the port,
against the JAX package on the CPU.

Inputs come from numpy seeds; parameters from the JAX ``CausalLM.init``,
carried across with ``repro_torch.convert``.  Tolerances are those of
``test_torch_lm.py``:

* ``flash_attention_ref`` with a window and a prefix against the
  reference's ``_attend_dense`` and ``_attend_blockwise``, float32: 2e-5
  (the blockwise path accumulates in the compute dtype, so it is held in
  float32 only);
* the mask predicate and the ring fold: exactly;
* whole models (forward logits, prefill logits, both cache trees, decode
  steps past the local ring's wrap): 1e-5 in float32, 1.5e-2 in bfloat16;
* the serving engine: equal greedy tokens, prompts of unequal length (the
  shared decode index of ROADMAP F4 included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro.models.transformer as RT
from repro.configs import get_smoke as r_get_smoke
from repro.models.model import CausalLM as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as REngine
from repro_torch import convert
from repro_torch.kernels import flash
from repro_torch.kernels.flash import flash_attention, flash_attention_ref
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from repro_torch.serve.engine import Request, ServeEngine

TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _qkv(seed, b, s, kvh, g, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, kvh * g, hd)).astype(np.float32),
            rng.standard_normal((b, s, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, s, kvh, hd)).astype(np.float32))


# --------------------------------------------------------------------------
# (a) the mask and the plain version of K3
# --------------------------------------------------------------------------
@pytest.mark.parametrize("window,prefix", [(None, 0), (4, 0), (1, 0), (None, 6),
                                           (5, 7), (40, 3)])
def test_mask_block_matches_reference(window, prefix):
    rng = np.random.default_rng(3)
    q_pos = rng.integers(-3, 30, 17).astype(np.int32)
    k_pos = rng.integers(-3, 30, 23).astype(np.int32)
    kw = dict(d_model=1, n_heads=1, n_kv_heads=1, head_dim=1, window=window,
              prefix_len=prefix)
    want = np.asarray(RA._mask_block(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                     RA.AttnConfig(**kw)))
    got = PA._mask_block(torch.as_tensor(q_pos), torch.as_tensor(k_pos),
                         PA.AttnConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [13, 37])
@pytest.mark.parametrize("window,prefix", [(1, 0), (5, 0), (16, 0), (64, 0),
                                           (None, 3), ("S", 0), (None, "S"),
                                           (5, 3)])
def test_flash_ref_with_window_and_prefix_matches_attend_dense(s, window, prefix):
    window = s if window == "S" else window
    prefix = s if prefix == "S" else prefix
    q, k, v = _qkv(s + (window or 0), 2, s, 2, 2, 16)
    cap = 20.0 if s == 37 else None
    cfg = RA.AttnConfig(d_model=1, n_heads=4, n_kv_heads=2, head_dim=16,
                        softcap=cap, window=window, prefix_len=prefix)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = _np(RA._attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                cfg, pos, pos))
    got = flash_attention_ref(_t(q), _t(k), _t(v), softcap=cap, window=window,
                              prefix_len=prefix).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_flash_ref_matches_attend_blockwise_past_its_threshold():
    """S = 2600 > BLOCKWISE_THRESHOLD: the reference's model path takes its
    online-softmax scan over 512-key blocks, with a window of 1024 and a
    prefix of 300 together."""
    s = 2600
    assert s > RA.BLOCKWISE_THRESHOLD
    q, k, v = _qkv(11, 1, s, 1, 2, 8)
    cfg = RA.AttnConfig(d_model=1, n_heads=2, n_kv_heads=1, head_dim=8,
                        softcap=30.0, window=1024, prefix_len=300)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = _np(RA._attend_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    cfg, pos, pos))
    got = flash_attention_ref(_t(q), _t(k), _t(v), scale=cfg.scale, softcap=30.0,
                              window=1024, prefix_len=300).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_flash_ref_rows_that_see_nothing_give_zeros():
    """A window past the keys (T < S) leaves late rows with nothing
    visible: zeros, as K3's l == 0 rows; earlier rows are plain softmax."""
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((1, 10, 2, 8)))
    k, v = (_t(rng.standard_normal((1, 4, 1, 8))) for _ in range(2))
    out = flash_attention_ref(q, k, v, window=3)
    assert not out[:, 6:].any() and out[:, :6].abs().sum(-1).all()


@pytest.mark.parametrize("kw", [dict(window=0), dict(prefix_len=-1),
                                dict(window=4, causal=False),
                                dict(prefix_len=2, causal=False)])
def test_flash_rejects_bad_masks(kw):
    q, k, v = (_t(a) for a in _qkv(0, 1, 4, 1, 1, 8))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


# --------------------------------------------------------------------------
# (b) the local layers' ring cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [5, 8, 13])            # < W, = W, > W
def test_ring_from_full_matches_reference(s):
    w, max_len = 8, 20
    rng = np.random.default_rng(s)
    full = {n: rng.standard_normal((2, max_len, 3, 4)).astype(np.float32)
            for n in ("k", "v")}
    for a in full.values():
        a[:, s:] = 0.0                                   # a prefill cache
    want = RT._ring_from_full({n: jnp.asarray(a) for n, a in full.items()}, s, w)
    got = PT._ring_from_full({n: torch.as_tensor(a) for n, a in full.items()}, s, w)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


# --------------------------------------------------------------------------
# (c) whole models: forward, prefill + both caches, decode past the wrap
# --------------------------------------------------------------------------
B, MAX_LEN, DECODE = 2, 40, 10
# gemma2 smoke: window 16, a 24-token prompt (the ring wraps in prefill),
# decode at 24..33 (past slot 15 into slot 0 again at 32); paligemma smoke:
# prefix 8, a 12-token prompt, or 8 prefix embeddings and 6 tokens
CASES = {"gemma2": ("gemma2-2b", 24, 0), "paligemma": ("paligemma-3b", 12, 0),
         "paligemma-embeds": ("paligemma-3b", 6, 8)}


def _inputs(cfg, s, n_embeds):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    embeds = (rng.standard_normal((B, n_embeds, cfg.d_model)).astype(np.float32) * 0.02
              if n_embeds else None)
    return tokens, embeds


def _run_reference(cfg, params, tokens, embeds):
    model = RModel(cfg)
    batch = {"tokens": jnp.asarray(tokens)}
    if embeds is not None:
        batch["prefix_embeds"] = jnp.asarray(embeds)
    logits, _ = jax.jit(model.forward)(params, batch)
    pre, cache = jax.jit(model.prefill, static_argnums=(2,), static_argnames=("cache_dtype",))(
        params, batch, MAX_LEN, cache_dtype=jnp.float32)
    caches = [jax.tree.map(np.asarray, cache)]
    decode = jax.jit(model.decode_step)
    start = logits.shape[1]
    steps, tok = [], jnp.argmax(pre[:, -1], -1)[:, None].astype(jnp.int32)
    for i in range(DECODE):
        lg, cache = decode(params, tok, cache, jnp.asarray(start + i, jnp.int32))
        steps.append((np.asarray(tok), _np(lg)))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    caches.append(jax.tree.map(np.asarray, cache))
    return _np(logits), _np(pre), caches, steps


def _assert_cache_close(cache, want, tol):
    got = convert.lm_cache_to_reference(cache)
    assert sorted(got) == sorted(want)
    for group in want:
        for name in ("k", "v"):
            np.testing.assert_allclose(got[group][name], np.asarray(want[group][name]),
                                       atol=tol, rtol=tol, err_msg=f"{group}.{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_reference(case, dtype):
    arch, s, n_embeds = CASES[case]
    cfg = dataclasses.replace(r_get_smoke(arch), dtype=dtype)
    params = RModel(cfg).init(jax.random.PRNGKey(7))
    tokens, embeds = _inputs(cfg, s, n_embeds)
    want_fwd, want_pre, want_caches, want_steps = _run_reference(cfg, params, tokens,
                                                                 embeds)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                             device="cpu")
    tol = TOL[dtype]
    pe = None if embeds is None else torch.as_tensor(embeds)
    logits, _ = model(torch.as_tensor(tokens), prefix_embeds=pe)
    np.testing.assert_allclose(logits.numpy(), want_fwd, atol=tol, rtol=0)
    pre, cache = model.prefill(torch.as_tensor(tokens), MAX_LEN,
                               cache_dtype=torch.float32, prefix_embeds=pe)
    np.testing.assert_allclose(pre.numpy(), want_pre, atol=tol, rtol=0)
    _assert_cache_close(cache, want_caches[0], tol)
    start = logits.shape[1]
    for i, (tok, want) in enumerate(want_steps):
        lg, cache = model.decode_step(torch.tensor(tok), cache, start + i)
        np.testing.assert_allclose(lg.numpy(), want, atol=tol, rtol=0)
    _assert_cache_close(cache, want_caches[1], tol)


def test_prefix_embeds_only_for_the_vlm_family():
    cfg = r_get_smoke("gemma2-2b")
    params = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(0)))
    model = convert.lm_params_from_reference(params, cfg, device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        model(torch.zeros(1, 4, dtype=torch.int64),
              prefix_embeds=torch.zeros(1, 2, cfg.d_model))


def test_prefill_attends_through_k3_with_the_layer_masks(monkeypatch):
    """Every layer's prefill attention reaches K3's wrapper with its
    layer's mask: gemma2 alternates window 16 and none, paligemma passes
    its prefix of 8 on every layer."""
    seen = []

    def recording(q, k, v, **kw):
        seen.append((kw["window"], kw["prefix_len"]))
        return flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(flash, "flash_attention", recording)
    for arch, want in (("gemma2-2b", [(16, 0), (None, 0)]),
                       ("paligemma-3b", [(None, 8), (None, 8)])):
        seen.clear()
        cfg = r_get_smoke(arch)
        params = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(0)))
        model = convert.lm_params_from_reference(params, cfg, device="cpu")
        model.prefill(torch.zeros(1, 10, dtype=torch.int64), 16)
        assert seen == want
        seen.clear()
        model.decode_step(torch.zeros(1, 1, dtype=torch.int64),
                          model.init_cache(1, 16), 3)
        assert seen == []


# --------------------------------------------------------------------------
# (d) the serving engine, convert, the launcher
# --------------------------------------------------------------------------
PROMPTS = [(21, 6), (9, 4), (14, 5)]     # (prompt length, new tokens)


@pytest.mark.parametrize("arch", ["gemma2-2b", "paligemma-3b"])
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
    _assert_cache_close(eng.cache, jax.tree.map(np.asarray, ref.cache), 1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "paligemma-3b"])
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
    # a cache tree (gemma2: local ring and global k/v) both ways
    rng = np.random.default_rng(4)
    ref_cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, rmodel.init_cache(2, 24, jnp.float32)))
    port = convert.lm_cache_from_reference(ref_cache, device="cpu")
    assert sorted(port) == sorted(ref_cache)
    assert jax.tree.map(np.shape, convert.lm_cache_to_reference(port)) == \
        jax.tree.map(np.shape, ref_cache)
    for group in ref_cache:
        for name in ("k", "v"):
            assert tuple(port[group][name].shape) == tuple(
                model.init_cache(2, 24)[group][name].shape)
            assert (convert.lm_cache_to_reference(port)[group][name].tobytes()
                    == ref_cache[group][name].tobytes())


def test_launcher_serves_gemma2_smoke_on_cpu(capsys):
    flash_attention.launches = 0
    finished = launcher.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                              "--requests", "3", "--slots", "2", "--prompt-len", "20",
                              "--max-new", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert len(finished) == 3 and all(len(r.out_tokens) == 3 for r in finished)
    assert "gemma2-2b-smoke" in out and "K3 flash_attention launches: 0" in out
