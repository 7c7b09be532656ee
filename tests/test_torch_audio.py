"""The port's audio family (musicgen-large: K = 4 codebooks, the EnCodec
encoder a stub) on the CPU against the JAX package.

Parameters come from the JAX ``CausalLM.init``, carried across with
``repro_torch.convert`` (``embed`` (K, V, D), ``lm_head`` (D, K·V)); tokens
(B, S, K) from a numpy seed.  Forward logits (B, S, K, V), prefill logits
and cache, and four decode steps with (B, 1, K) tokens: 1e-5 absolute in
float32, 1.5e-2 in bfloat16 (the tolerances of ``test_torch_lm.py``, for
the same reasons).  ``ServeEngine`` refuses the family, as the reference's
cannot serve it (ROADMAP §3 F6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models.model import CausalLM as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as REngine
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.model import CausalLM
from repro_torch.serve.engine import ServeEngine

ARCH = "musicgen-large"
B, S, MAX_LEN, DECODE = 2, 12, 20, 4
TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_model_matches_reference(dtype):
    cfg = dataclasses.replace(r_get_smoke(ARCH), dtype=dtype)
    k = cfg.num_codebooks
    ref = RModel(cfg)
    params = ref.init(jax.random.PRNGKey(4))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S, k)).astype(np.int32)
    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             dataclasses.replace(get_smoke(ARCH), dtype=dtype),
                                             device="cpu")
    assert tuple(model.embed.shape) == (k, cfg.vocab_size, cfg.d_model)
    assert tuple(model.lm_head.shape) == (cfg.d_model, k * cfg.vocab_size)
    tol = TOL[dtype]

    want, _ = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(tokens)})
    logits, aux = model.forward(torch.as_tensor(tokens))
    assert logits.shape == (B, S, k, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), _np(want), atol=tol, rtol=0)

    pre_w, cache_w = jax.jit(ref.prefill, static_argnums=(2,),
                             static_argnames=("cache_dtype",))(
        params, {"tokens": jnp.asarray(tokens)}, MAX_LEN, cache_dtype=jnp.float32)
    pre, cache = model.prefill(torch.as_tensor(tokens), MAX_LEN, cache_dtype=torch.float32)
    assert pre.shape == (B, 1, k, cfg.vocab_size)
    np.testing.assert_allclose(pre.numpy(), _np(pre_w), atol=tol, rtol=0)
    decode = jax.jit(ref.decode_step)
    tok = np.asarray(jnp.argmax(pre_w[:, -1], -1)[:, None].astype(jnp.int32))   # (B, 1, K)
    for i in range(DECODE):
        lw, cache_w = decode(params, jnp.asarray(tok), cache_w, jnp.asarray(S + i, jnp.int32))
        lg, cache = model.decode_step(torch.tensor(tok), cache, S + i)
        assert lg.shape == (B, 1, k, cfg.vocab_size)
        np.testing.assert_allclose(lg.numpy(), _np(lw), atol=tol, rtol=0)
        tok = np.asarray(jnp.argmax(lw[:, -1], -1)[:, None].astype(jnp.int32))
    got = convert.lm_cache_to_reference(cache)
    for name in ("k", "v"):
        np.testing.assert_allclose(got["layers"][name], np.asarray(cache_w["layers"][name]),
                                   atol=tol, rtol=tol)


def test_audio_convert_round_trip_is_byte_equal():
    cfg = r_get_smoke(ARCH)
    params = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(3)))
    model = convert.lm_params_from_reference(params, get_smoke(ARCH), device="cpu")
    back = convert.lm_params_to_reference(model)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), path
    assert model.param_count() == RModel(cfg).param_count(params)


def test_audio_tokens_must_carry_every_codebook():
    model = CausalLM(get_smoke(ARCH), device="cpu", seed=0)
    with pytest.raises(ValueError, match=r"\(B, S, 4\)"):
        model.forward(torch.zeros(1, 8, dtype=torch.long))


def test_serve_engine_refuses_audio_as_the_reference_cannot_serve_it():
    """F6: the reference's engine feeds (slots, 1) decode tokens to the
    codebook embedding and fails; the port's refuses up front."""
    cfg = r_get_smoke(ARCH)
    ref = REngine(RModel(cfg), RModel(cfg).init(jax.random.PRNGKey(0)), 2, 16)
    for rid in range(2):
        ref.submit(RRequest(rid=rid, prompt=np.zeros((4, cfg.num_codebooks), np.int32),
                            max_new_tokens=2))
    with pytest.raises(TypeError, match="reshape"):
        ref.run()
    model = CausalLM(get_smoke(ARCH), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="F6"):
        ServeEngine(model, 2, 16)
    with pytest.raises(NotImplementedError, match="F6"):
        serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
