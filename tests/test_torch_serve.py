"""The port's ServeEngine against the JAX package's, and the port's LM
rules: what it refuses, what reaches K3, and where it runs.

Engine parity: the same parameters (JAX ``CausalLM.init``, carried across
with ``repro_torch.convert``), 2 slots and 3 requests so that a slot is
refilled, greedy, float32.  The tokens must be identical and the logits of
every sampling call (prefill and decode) within 1e-5.  Sampled tokens
(temperature > 0) cannot match ``jax.random``; they are checked for
reproducibility and range only.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models.model import CausalLM as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as REngine
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash
from repro_torch.kernels.flash import flash_attention
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as PA
from repro_torch.models.model import CausalLM
from repro_torch.serve.engine import Request, ServeEngine

PROMPTS = [(11, 5), (7, 3), (9, 4)]   # (prompt length, new tokens)


def _record(engine):
    """Wrap ``engine._sample`` to keep every logits batch it is given."""
    seen, sample = [], engine._sample

    def wrapped(logits, temperatures):
        seen.append(np.asarray(logits if isinstance(logits, jax.Array)
                               else logits.cpu().numpy(), np.float32))
        return sample(logits, temperatures)

    engine._sample = wrapped
    return seen


@pytest.mark.parametrize("arch", ["starcoder2-3b", "chatglm3-6b"])
def test_serve_engine_matches_reference(arch):
    cfg = dataclasses.replace(r_get_smoke(arch), dtype="float32")
    params = RModel(cfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(9)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
               for n, new in PROMPTS]

    ref = REngine(RModel(cfg), params, 2, 32)
    ref_logits = _record(ref)
    for i, (p, new) in enumerate(prompts):
        ref.submit(RRequest(rid=i, prompt=p, max_new_tokens=new))
    ref_out = {r.rid: r.out_tokens for r in ref.run()}

    model = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                             cfg, device="cpu")
    eng = ServeEngine(model, 2, 32)
    logits = _record(eng)
    for i, (p, new) in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    out = {r.rid: r.out_tokens for r in eng.run()}

    assert out == ref_out
    assert [len(out[i]) for i in range(3)] == [new for _, new in PROMPTS]
    assert len(logits) == len(ref_logits)
    for got, want in zip(logits, ref_logits):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert eng.tokens == {"prefill": sum(n for n, _ in PROMPTS),
                          "decode": sum(new - 1 for _, new in PROMPTS)}
    assert eng.phase_ms["prefill"] > 0 and eng.phase_ms["decode"] > 0


def test_engine_counts_k3_launches_by_phase(monkeypatch):
    """The engine reads K3's counter around each phase's calls.  On the CPU
    the wrapper launches nothing, so a stand-in counts as the card's
    wrapper does: one per call."""
    def counting(q, k, v, **kw):
        flash_attention.launches += 1
        return flash.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(flash, "flash_attention", counting)
    monkeypatch.setattr(flash_attention, "launches", 0)
    cfg = get_smoke("starcoder2-3b")
    eng = ServeEngine(CausalLM(cfg, device="cpu", seed=0), 2, 32)
    for i, (n, new) in enumerate(PROMPTS):
        eng.submit(Request(rid=i, prompt=np.arange(n, dtype=np.int32),
                           max_new_tokens=new))
    eng.run()
    assert eng.k3_launches == {"prefill": len(PROMPTS) * cfg.n_layers, "decode": 0}
    assert flash_attention.launches == len(PROMPTS) * cfg.n_layers


def test_sampling_is_per_slot_and_reproducible():
    model = CausalLM(get_smoke("starcoder2-3b"), device="cpu", seed=0)
    logits = torch.tensor([[1.0, -1e9, 1.01], [0.0, 0.0, 9.0]])
    draws = []
    for seed in (4, 4):
        eng = ServeEngine(model, 2, 8, seed=seed)
        draws.append([tuple(eng._sample(logits, [1.0, 0.0])) for _ in range(32)])
    assert draws[0] == draws[1]
    assert {d[0] for d in draws[0]} == {0, 2}       # never the -1e9 token
    assert {d[1] for d in draws[0]} == {2}          # temperature 0: argmax
    eng = ServeEngine(model, 2, 8)
    np.testing.assert_array_equal(eng._sample(logits, [0.0, 0.0]), [2, 2])


# --------------------------------------------------------------------------
# (f) what the port refuses, and where it runs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["musicgen-large"])
def test_unported_families_and_patterns_raise(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        CausalLM(get_smoke(arch), device="cpu")


def test_k3_takes_windows_and_prefixes_on_the_cpu():
    """A window and a prefix reach K3's wrapper, which runs its plain
    version on CPU tensors: the same output as the plain version with that
    mask, unlike the global causal one, and no launch."""
    cfg = PA.AttnConfig(d_model=16, n_heads=2, n_kv_heads=1, head_dim=8)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 6, 16, generator=gen)
    p = {name: torch.randn(shape, generator=gen) for name, shape in
         (("wq", (16, 16)), ("wk", (16, 8)), ("wv", (16, 8)), ("wo", (16, 16)))}
    pos = torch.arange(6)[None]
    flash_attention.launches = 0
    plain = PA.attention(p, x, cfg, pos)
    for masked in (dataclasses.replace(cfg, window=2),
                   dataclasses.replace(cfg, prefix_len=4)):
        q, k, v = PA._project_qkv(p, x, masked, pos)
        want = flash.flash_attention_ref(
            q, k, v, scale=masked.scale, window=masked.window,
            prefix_len=masked.prefix_len).reshape(1, 6, 16) @ p["wo"]
        got = PA.attention(p, x, masked, pos)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert not torch.allclose(got, plain)
        cache = PA.init_kv_cache(1, 8, masked, dtype=torch.float32)
        torch.testing.assert_close(PA.attention_prefill(p, x, masked, pos, cache),
                                   want, rtol=0, atol=0)
    assert flash_attention.launches == 0


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("starcoder2-3b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--smoke", "--requests", "1"])
    model = CausalLM(cfg, device="cpu")
    eng = ServeEngine(model, 1, 8)
    assert model.embed.device.type == eng.cache["layers"]["k"].device.type == "cpu"


def test_launcher_serves_smoke_on_cpu(capsys):
    flash_attention.launches = 0
    finished = launcher.main(["--smoke", "--device", "cpu", "--requests", "3",
                              "--slots", "2", "--prompt-len", "8",
                              "--max-new", "3", "--max-len", "16"])
    out = capsys.readouterr().out
    assert len(finished) == 3 and all(len(r.out_tokens) == 3 for r in finished)
    assert "on cpu" in out and "K3 flash_attention launches: 0" in out
    assert flash_attention.launches == 0


def test_port_init_matches_reference_shapes():
    """The port's own init: the reference's shapes, scales and constant
    parameters (its draws differ)."""
    cfg = get_smoke("qwen1.5-32b")
    model = CausalLM(cfg, device="cpu", seed=0)
    ref = convert.lm_params_to_reference(model)
    want = RModel(r_get_smoke("qwen1.5-32b")).init(jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, want)
    layers = ref["stack"]["layers"]
    assert abs(float(np.std(layers["attn"]["wq"])) - 0.02) < 2e-3
    assert abs(float(np.std(layers["attn"]["wo"])) - 0.02 / np.sqrt(2)) < 2e-3
    assert not layers["attn"]["bq"].any() and (layers["norm_attn"] == 1).all()
    again = convert.lm_params_to_reference(CausalLM(cfg, device="cpu", seed=0))
    assert jax.tree.all(jax.tree.map(np.array_equal, ref, again))
