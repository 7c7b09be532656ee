"""The port's training path on the CPU against the JAX package.

Inputs come from numpy seeds; parameters from the JAX ``CausalLM.init``,
carried across with ``repro_torch.convert``.  Models compute in float32
(``dataclasses.replace(cfg, dtype="float32")``).  Tolerances:

* the token pipeline: byte-equal batches; the decay mask: equal on every
  leaf;
* ``schedule_lr``, the bias corrections and one AdamW update: 1e-6
  relative (float32 ops in the same order; ``cos`` and ``pow`` may differ
  in the last bit between XLA and PyTorch);
* ``Compressor.roundtrip``: exact on tie-free inputs (both round half to
  even), 1e-7 relative for the int8 scale;
* ``flash_attention_bwd_ref`` against ``jax.vjp`` of the reference's
  ``_attend_blockwise`` (block 16), float32: 1e-5 absolute on gradients
  of order 1;
* whole-model loss and every gradient: 1e-5 relative (to the leaf's
  largest gradient); K3's float32 q scaling and probabilities against the
  reference's dense path differ by ~1e-7;
* three train steps: losses and grad norms to 1e-5 relative; parameters
  to 1e-4 absolute on values of order 0.02, because AdamW's g / (sqrt(v)
  + eps) turns a ~1e-7 difference of a gradient near eps (1e-8) into up to
  a full step of lr = 1e-3 in that element;
* the launcher's resume across packages: step 3's loss to 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as r_launch
import repro.models.attention as RA
from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_smoke as r_get_smoke
from repro.data import tokens as r_tokens
from repro.dist import compress as r_compress
from repro.dist import ft as r_ft
from repro.models.model import CausalLM as RModel
from repro.optim import adamw as r_adamw
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.data import tokens as p_tokens
from repro_torch.dist import compress as p_compress
from repro_torch.dist import ft as p_ft
from repro_torch.kernels import flash
from repro_torch.launch import train as p_launch
from repro_torch.models.model import CausalLM
from repro_torch.optim import adamw as p_adamw
from repro_torch.train.step import make_eval_step, make_train_step

from _train_parity import batch as _batch
from _train_parity import check_loss_and_grads
from _train_parity import f32 as _f32
from _train_parity import pair as _pair
from _train_parity import ref_leaf as _ref_leaf
from _train_parity import rel as _rel

TRAINED = ("starcoder2-3b", "musicgen-large")


@pytest.fixture(autouse=True)
def _no_signal_handlers(monkeypatch):
    """The launchers' preemption handlers, without taking over SIGTERM in
    the test process."""
    for mod in (r_launch, p_launch):
        handler = mod.PreemptionHandler
        monkeypatch.setattr(mod, "PreemptionHandler", lambda h=handler: h(signals=()))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "audio", "vlm"])
def test_make_batch_is_byte_equal(kind):
    kw = {"dense": {}, "audio": {"num_codebooks": 4},
          "vlm": {"prefix_tokens": 8, "d_model": 16}}[kind]
    args = dict(vocab_size=97, seq_len=40, global_batch=4, seed=3, segment_len=8, **kw)
    rc, pc = r_tokens.DataConfig(**args), p_tokens.DataConfig(**args)
    for step in (0, 1, 7):
        for shard, shards in ((0, 1), (1, 2), (3, 4)):
            want = r_tokens.make_batch(rc, step, shard, shards)
            got = p_tokens.make_batch(pc, step, shard, shards)
            assert want.keys() == got.keys()
            for key in want:
                assert want[key].dtype == got[key].dtype
                assert want[key].tobytes() == got[key].tobytes()
    pipe = p_tokens.TokenPipeline(pc)
    pipe.next(), pipe.next()
    state = pipe.state()
    again = p_tokens.TokenPipeline(pc)
    again.restore(state)
    assert again.next()["tokens"].tobytes() == pipe.next()["tokens"].tobytes()


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", R_ARCHS)
def test_decay_mask_equals_reference_on_every_leaf(arch):
    """F7: the reference decides on the stacked leaf's ndim, so per-layer
    vectors outside the excluded names are decayed; the port decides on
    the reference's path and that ndim."""
    cfg = r_get_smoke(arch)
    params = jax.eval_shape(RModel(cfg).init, jax.random.PRNGKey(0))
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: want.__setitem__(
            tuple(str(p.key) for p in path), r_adamw._decay_mask(path, len(leaf.shape))),
        params)
    model = CausalLM(get_smoke(arch), device="cpu", seed=None)
    got = {}
    for name, p in model.named_parameters():
        path, _ = convert._reference_path(name)
        got.setdefault(path, set()).add(p_adamw.decays(name, p.dim()))
    assert set(got) == set(want)
    assert {path: {v} for path, v in want.items()} == got
    if arch == "starcoder2-3b":
        assert want[("stack", "layers", "attn", "bq")]          # F7
        assert not want[("stack", "layers", "norm_attn")]


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches(schedule):
    rc = r_adamw.AdamWConfig(warmup_steps=5, total_steps=40, schedule=schedule, lr=3e-4)
    pc = p_adamw.AdamWConfig(**dataclasses.asdict(rc))
    for step in range(0, 45, 3):
        want = float(r_adamw.schedule_lr(rc, jnp.int32(step)))
        got = p_adamw.schedule_lr(pc, step)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_apply_updates_matches_reference():
    ref, params, model = _pair("starcoder2-3b")
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32)
                         * np.float32(0.1), params)
    named = dict(model.named_parameters())
    pgrads = {n: torch.tensor(_ref_leaf(grads, n)) for n in named}
    rc = r_adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    pc = p_adamw.AdamWConfig(**dataclasses.asdict(rc))
    r_state = r_adamw.init_state(params)
    p_state = p_adamw.init_state(named)
    r_apply = jax.jit(r_adamw.apply_updates, static_argnums=3)
    for step in range(2):
        params, r_state, r_m = r_apply(params, r_state, grads, rc, jnp.int32(step))
        _, p_state, p_m = p_adamw.apply_updates(named, p_state, pgrads, pc, step)
        assert _rel(float(p_m["grad_norm"]), float(r_m["grad_norm"])) <= 1e-6
        assert _rel(float(p_m["lr"]), float(r_m["lr"])) <= 1e-6
    assert int(p_state["count"]) == int(r_state["count"]) == 2
    for name, p in named.items():
        assert _rel(p.detach().numpy(), _ref_leaf(params, name)) <= 1e-6, name
        for part in ("m", "v"):
            assert _rel(p_state[part][name].numpy(),
                        _ref_leaf(r_state[part], name)) <= 1e-6, (part, name)
    # the state carries across in the reference's layout
    tree = convert.opt_state_to_reference(p_state)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, r_state))


# --------------------------------------------------------------------------
# compression and the watchdog
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["none", "fp16", "int8", "topk"])
def test_compressor_roundtrip_and_error_feedback_match(kind):
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((33, 7)).astype(np.float32),
             "b": {"c": rng.standard_normal(101).astype(np.float32) * 1e-3}}
    rcmp, pcmp = r_compress.Compressor(kind, 0.2), p_compress.Compressor(kind, 0.2)
    tg = jax.tree.map(torch.tensor, grads)
    want = r_compress.Compressor.roundtrip(rcmp, jax.tree.map(jnp.asarray, grads))
    got = pcmp.roundtrip(tg)
    for path in (("a",), ("b", "c")):
        w, g = want, got
        for key in path:
            w, g = w[key], g[key]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, atol=0)
    dec, ef = pcmp.encode_decode(tg, pcmp.init(tg))
    rdec, ref_ef = rcmp.encode_decode(jax.tree.map(jnp.asarray, grads),
                                      rcmp.init(jax.tree.map(jnp.asarray, grads)))
    np.testing.assert_allclose(dec["a"].numpy(), np.asarray(rdec["a"]), rtol=1e-7)
    np.testing.assert_allclose(ef["b"]["c"].numpy(), np.asarray(ref_ef["b"]["c"]),
                               rtol=1e-6, atol=1e-12)
    assert pcmp.traffic_ratio() == rcmp.traffic_ratio()


def test_step_watchdog_reports_match():
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 2.5, 1.05, 3.0]
    rw, pw = r_ft.StepWatchdog(window=4, threshold=2.0), p_ft.StepWatchdog(window=4, threshold=2.0)
    for step, sec in enumerate(times):
        want, got = rw.observe(step, sec), pw.observe(step, sec)
        assert dataclasses.asdict(want) == dataclasses.asdict(got)
    plan = p_ft.elastic_plan(8, 4, 32, 100)
    assert dataclasses.asdict(plan) == dataclasses.asdict(r_ft.elastic_plan(8, 4, 32, 100))
    handler = p_ft.PreemptionHandler(signals=())
    assert not handler.requested
    handler.request()
    assert handler.requested


# --------------------------------------------------------------------------
# K3's gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("window,prefix,softcap", [
    (None, 0, None), (5, 0, None), (None, 11, None), (None, 0, 3.0), (7, 20, 3.0)])
def test_flash_bwd_ref_matches_reference_vjp(group, window, prefix, softcap):
    b, s, kvh, hd = 2, 40, 2, 8
    rng = np.random.default_rng(group)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((b, s, kvh * group, hd), (b, s, kvh, hd), (b, s, kvh, hd),
                    (b, s, kvh * group, hd)))
    cfg = RA.AttnConfig(d_model=0, n_heads=kvh * group, n_kv_heads=kvh, head_dim=hd,
                        softcap=softcap, window=window, prefix_len=prefix)
    pos = jnp.arange(s, dtype=jnp.int32)
    out, vjp = jax.vjp(lambda q, k, v: RA._attend_blockwise(q, k, v, cfg, pos, pos,
                                                            block=16), q, k, v)
    want = vjp(jnp.asarray(do))
    kw = dict(scale=cfg.scale, softcap=softcap, window=window, prefix_len=prefix)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    tout = flash.flash_attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-5)
    got = flash.flash_attention_bwd_ref(tq, tk, tv, tout, torch.tensor(do), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("window,prefix,softcap", [
    (None, 0, None), (3, 0, 2.0), (2, 4, 1.5)])
def test_flash_attention_function_gradcheck(window, prefix, softcap):
    """``FlashAttention`` (the plain versions on the CPU: saved tensors,
    the GQA sum, ``None`` for the non-tensor arguments) is the gradient of
    its forward, in float64."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for shape in ((1, 7, 4, 4), (1, 7, 2, 4), (1, 7, 2, 4)))
    fn = lambda q, k, v: flash.FlashAttention.apply(q, k, v, None, softcap, True,
                                                     window, prefix)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_flash_attention_function_counts_no_launch_on_the_cpu():
    flash.flash_attention.launches = flash.flash_attention_bwd.launches = 0
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, requires_grad=True)
    out = flash.FlashAttention.apply(q, k, k, None, None, True, None, 0)
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert flash.flash_attention.launches == flash.flash_attention_bwd.launches == 0


# --------------------------------------------------------------------------
# models: loss and grads
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """Over 4 loss chunks (LOSS_CHUNK 8 of 32 positions), labels with the
    masked last position and a few more set to -1."""
    check_loss_and_grads(arch, monkeypatch)


@pytest.mark.parametrize("arch", R_ARCHS)
def test_every_family_records_grads(arch):
    """Under grad ``forward`` records (the logits carry a graph and a
    backward reaches every parameter); under ``no_grad`` it records
    nothing."""
    cfg = get_smoke(arch)
    model = CausalLM(cfg, device="cpu", seed=0)
    shape = (1, 8, cfg.num_codebooks) if cfg.family == "audio" else (1, 8)
    tokens = torch.zeros(shape, dtype=torch.long)
    prefix = (torch.zeros(1, cfg.prefix_tokens, cfg.d_model) if cfg.family == "vlm"
              else None)
    with torch.no_grad():
        logits, aux = model.forward(tokens, prefix)
    assert not logits.requires_grad and not aux.requires_grad
    logits, aux = model.forward(tokens, prefix)
    assert logits.grad_fn is not None
    (logits.float().square().mean() + aux).backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("arch,microbatches", [("starcoder2-3b", 1),
                                               ("starcoder2-3b", 2),
                                               ("musicgen-large", 2)])
def test_three_train_steps_match_reference(arch, microbatches):
    ref, params, model = _pair(arch, seed=1)
    rc = r_adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    r_step = jax.jit(r_make_train_step(ref, rc, microbatches=microbatches))
    p_step = make_train_step(model, p_adamw.AdamWConfig(**dataclasses.asdict(rc)),
                             microbatches=microbatches)
    r_state = r_adamw.init_state(params)
    p_state = p_adamw.init_state(dict(model.named_parameters()))
    for step in range(3):
        batch = _batch(ref.cfg, b=4, s=16, seed=step)
        params, r_state, r_m = r_step(params, r_state,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jnp.int32(step))
        p_state, p_m = p_step(p_state, batch, step)
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert _rel(float(p_m[key]), float(r_m[key])) <= 1e-5, (step, key)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(params, name),
                                   atol=1e-4, err_msg=name)
    metrics = make_eval_step(model)(_batch(ref.cfg, b=2, s=16, seed=9))
    assert np.isfinite(float(metrics["loss"])) and not metrics["loss"].requires_grad


# one arch of each stacked-tree shape: one list of layers, zamba2's
# mamba/shared/lora groups, deepseek's dense_layers/moe_layers
TREES = ("starcoder2-3b", "zamba2-2.7b", "deepseek-moe-16b")


@pytest.mark.parametrize("arch", TREES)
def test_server_sees_the_weights_after_a_train_step(arch):
    """A parameter that trains is cast anew at each read: a prefill after
    an optimizer step reads the new weights and keeps no bf16 copy.  A
    server's frozen parameters keep their copies, keyed on each
    parameter's version: loading the trained weights in place replaces
    them."""
    cfg = get_smoke(arch)                          # bfloat16 compute
    model = CausalLM(cfg, device="cpu", seed=0)
    server = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
    toks = torch.as_tensor(_batch(cfg)["tokens"]).long()
    before, _ = server.prefill(toks, 40)
    assert torch.equal(model.prefill(toks, 40)[0], before)
    step = make_train_step(model, p_adamw.AdamWConfig(lr=1e-2, warmup_steps=1))
    state = p_adamw.init_state(dict(model.named_parameters()))
    state, _ = step(state, _batch(cfg), 0)
    after, _ = model.prefill(toks, 40)
    assert not any(m.__dict__.get("_cast_cache") for m in model.modules())
    assert any(m.__dict__.get("_cast_cache") for m in server.modules())
    convert.load_params(server, convert.lm_params_to_reference(model))
    served, _ = server.prefill(toks, 40)
    fresh = CausalLM(cfg, device="cpu", seed=None)
    fresh.load_state_dict(model.state_dict())
    want, _ = fresh.prefill(toks, 40)
    assert not torch.equal(before, after)
    assert torch.equal(after, want) and torch.equal(served, want)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launcher_trains_a_smoke_config_on_the_cpu(capsys):
    losses = p_launch.main(["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "32",
                            "--log-every", "1", "--compress", "int8",
                            "--microbatches", "2"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "arch=starcoder2-3b-smoke" in out and "step     2 loss" in out
    assert "final loss" in out


def test_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_launch.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", TREES)
@pytest.mark.parametrize("first", ["jax", "torch"])
def test_training_checkpoint_resumes_across_packages(first, arch, tmp_path, monkeypatch):
    """One package trains 2 steps and saves; the other resumes for step 3.
    Step 3's loss equals that of a 3-step run in one package (float32
    compute in both launchers)."""
    monkeypatch.setattr(r_launch, "get_smoke", lambda a: _f32(r_get_smoke(a)))
    monkeypatch.setattr(p_launch, "get_smoke", lambda a: _f32(get_smoke(a)))
    args = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--log-every", "1"]
    run = {"jax": lambda a: r_launch.main(a),
           "torch": lambda a: p_launch.main(a + ["--device", "cpu"])}
    second = "torch" if first == "jax" else "jax"
    whole = run[first](args[:-4] + ["--steps", "3"])
    ck = str(tmp_path / "ck")
    run[first](args + ["--steps", "2", "--ckpt-dir", ck])
    resumed = run[second](args + ["--steps", "3", "--ckpt-dir", ck])
    assert len(resumed) == 1
    assert _rel(resumed[0], whole[2]) <= 1e-5


def test_launcher_preemption_saves_and_exits(tmp_path, monkeypatch, capsys):
    """A preemption request stops the run after the step in flight, with
    an emergency checkpoint of that step that the next run resumes."""
    def requested():
        handler = p_ft.PreemptionHandler(signals=())
        handler.request()
        return handler

    monkeypatch.setattr(p_launch, "PreemptionHandler", requested)
    args = ["--arch", "starcoder2-3b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--steps", "3", "--ckpt-dir", str(tmp_path)]
    assert len(p_launch.main(args)) == 1
    assert "emergency checkpoint at step 1; exiting" in capsys.readouterr().out
    monkeypatch.setattr(p_launch, "PreemptionHandler", lambda: p_ft.PreemptionHandler(()))
    assert len(p_launch.main(args)) == 2
    assert "resumed from step 1" in capsys.readouterr().out
