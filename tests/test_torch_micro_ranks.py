"""Microbatches and gradient compression across ranks on the CPU: a 2 x 2
world of gloo ranks (``repro_torch.dist.zero.ranked_lm``: the batch and
ZeRO-3 over "data", tensor, sequence and expert parallelism over "model")
takes one ``make_train_step`` step with ``microbatches`` and a compressor,
held in float32 to the reference's ``make_train_step`` with the same
microbatches and compressor on the global batch (the port's parameters
carried across with ``convert``) and to the port's unsharded step.

chatglm3-6b's smoke (dense) and deepseek-moe-16b's (MoE, at a capacity
factor, 8.0, that drops no pair: the aux loss depends on which tokens
share a microbatch, as the reference's), each at microbatches 2 with
int8 and 4 with top-k.  Each rank's batch is its rows of the global
microbatches (``TokenPipeline(..., microbatches=n)``: rank d's part i is
global rows i B/n + d B/(n D) ...).  Held:

* every rank: the compressed gradient shards equal, bit for bit, the
  compressor's roundtrip of the whole (gathered) gradient, cut to the
  rank's shard: int8's scale and top-k's threshold are the whole leaf's
  (the reference's: a stacked group of layers is one leaf);
* the step's gradient before compression (the microbatches' mean, every
  leaf gathered whole) within 1e-5 relative of the reference's
  ``jax.value_and_grad`` averaged over the same microbatches and of the
  unsharded step's; the step's loss, ce, aux and lr within 1e-5 of both,
  its grad norm (after compression) within 1e-5 of the norm of its whole
  gradient compressed, and of both within 1e-5 plus the norm of the moves
  the undecided elements (below) allow;
* the parameters after the step within 1e-4 of both, except where an
  element's int8 code or top-k membership is decided by less than the
  gradients' tolerance (its value within 1e-5 of the leaf's largest
  gradient of a rounding boundary or of the threshold): there a code may
  differ, which moves that element's first AdamW step by up to the
  learning rate.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ranks as R
from _train_parity import METRICS, ref_leaf, rel
from repro.configs import get_smoke as r_get_smoke
from repro.dist.compress import Compressor as RCompressor
from repro.models.model import CausalLM as RModel
from repro.optim import adamw as r_adamw
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.convert import _reference_path, lm_params_to_reference
from repro_torch.data.tokens import DataConfig, make_batch
from repro_torch.dist.compress import Compressor
from repro_torch.models.model import CausalLM
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.step import make_train_step

ARCHS = ("chatglm3-6b", "deepseek-moe-16b")
VARIANTS = ((2, "int8"), (4, "topk"))
DATA, MODEL, BATCH, SEQ = 2, 2, 8, 32
LR = R.OPT["lr"]

PROG = r"""
import sys, datetime
from pathlib import Path
import torch, torch.distributed as dist
sys.path.insert(0, "tests")
import _ranks as R
from repro_torch.convert import _reference_path, lm_params_to_reference
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist.compress import Compressor
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.step import make_train_step
rank, world, addr, out, arch, data, model, batch, seq = sys.argv[1:10]
rank, world, data, model, out = int(rank), int(world), int(data), int(model), Path(out)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
cfg = R.smoke_cfg(arch)
mesh = make_lm_mesh(data, model, "cpu")
res = {}
for mb, kind in ((2, "int8"), (4, "topk")):
    lm = ranked_lm(cfg, mesh, seed=0)
    place = lm.placement
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=int(seq),
                                    global_batch=int(batch), seed=0),
                         shard=place.data_rank, num_shards=data, microbatches=mb)
    rec = R.recording_compressor(kind)
    step_fn = make_train_step(lm, AdamWConfig(**R.OPT), microbatches=mb, compressor=rec)
    _, metrics = step_fn(init_state(dict(lm.named_parameters())), pipe.next(), 0)
    plain = Compressor(kind)
    whole = plain.roundtrip(rec.whole, plain.leaf_stats(rec.whole))
    for name, p in lm.named_parameters():
        assert torch.equal(rec.out[name], place.local(name, p, whole[name])), (name, kind)
    params = lm_params_to_reference(lm)
    if rank == 0:
        res[(mb, kind)] = {"metrics": {k: float(v) for k, v in metrics.items()},
                           "grads": rec.whole, "stats": rec.stats, "params": params}
if rank == 0:
    torch.save(res, out / "micro.pt")
dist.destroy_process_group()
print("RANK_OK")
"""


def _global_batch(cfg):
    return make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                                 seed=0), 0)


@lru_cache(maxsize=None)
def _reference(arch):
    """{(microbatches, kind): (metrics, the microbatches' mean gradient,
    parameters after the step)} of the reference's step from the port's
    seed-0 parameters, on the global batch."""
    cfg = R.smoke_cfg(arch)
    one = CausalLM(cfg, device="cpu", seed=0)
    params0 = jax.tree.map(jnp.asarray, lm_params_to_reference(one))
    rcfg = dataclasses.replace(r_get_smoke(arch), dtype="float32")
    if rcfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 capacity_factor=8.0))
    ref = RModel(rcfg)
    bt = {k: jnp.asarray(v) for k, v in _global_batch(cfg).items()}
    grad = jax.jit(jax.grad(lambda p, x: ref.loss(p, x)[0]))
    out = {}
    for mb, kind in VARIANTS:
        n = BATCH // mb
        parts = [grad(params0, {k: v[i * n:(i + 1) * n] for k, v in bt.items()})
                 for i in range(mb)]
        mean = jax.tree.map(lambda *g: np.asarray(sum(x.astype(jnp.float32) for x in g) / mb),
                            *parts)
        step = jax.jit(r_make_train_step(ref, r_adamw.AdamWConfig(**R.OPT), microbatches=mb,
                                         compressor=RCompressor(kind)))
        params, _, metrics = step(params0, r_adamw.init_state(params0), bt, jnp.int32(0))
        out[(mb, kind)] = ({k: float(v) for k, v in metrics.items()}, mean,
                           jax.tree.map(np.asarray, params))
    return out


@lru_cache(maxsize=None)
def _unsharded(arch):
    """The same for the port's unsharded step (its gradient as the
    compressor took it)."""
    cfg = R.smoke_cfg(arch)
    out = {}
    for mb, kind in VARIANTS:
        one = CausalLM(cfg, device="cpu", seed=0)
        rec = R.recording_compressor(kind)
        step_fn = make_train_step(one, AdamWConfig(**R.OPT), microbatches=mb, compressor=rec)
        _, metrics = step_fn(init_state(dict(one.named_parameters())), _global_batch(cfg), 0)
        out[(mb, kind)] = ({k: float(v) for k, v in metrics.items()}, rec.whole,
                           lm_params_to_reference(one))
    return out


_RUNS: dict = {}


def _ranked(arch, tmp_path_factory):
    if arch not in _RUNS:
        out = tmp_path_factory.mktemp(f"micro_{arch}")
        R.run_ranks(PROG, DATA * MODEL, out, arch, DATA, MODEL, BATCH, SEQ, timeout=150)
        _RUNS[arch] = torch.load(out / "micro.pt", weights_only=False)
    return _RUNS[arch]


def _undecided(g: torch.Tensor, stat: torch.Tensor, kind: str) -> np.ndarray:
    """Elements whose int8 code or top-k membership a change of ``tol`` =
    1e-5 of the leaf's largest |g| can move: in the element, and in the
    statistic (the scale, max |g| / 127, moves a boundary (k + 1/2) scale
    by at most ``tol``; the threshold by ``tol``)."""
    g, stat = g.abs().double(), float(stat)
    tol = 1e-5 * max(float(g.max()), stat if kind == "int8" else 0.0)
    if kind == "int8":
        scale = max(stat, 1e-30) / 127.0
        t = g / scale
        return ((t - t.floor() - 0.5).abs() * scale <= 2 * tol).numpy()
    return ((g - stat).abs() <= 2 * tol).numpy()


def _close_params(got: dict, want: dict, undecided: dict, path=""):
    if isinstance(want, dict):
        for k in want:
            _close_params(got[k], want[k], undecided, f"{path}/{k}")
        return
    diff = np.abs(np.asarray(got) - np.asarray(want))
    mask = undecided.get(path)
    if mask is not None:
        assert diff[mask].max(initial=0.0) <= LR + 1e-4, path
        diff = diff[~mask]
    assert diff.max(initial=0.0) <= 1e-4, path


@pytest.mark.parametrize("variant", VARIANTS, ids=[f"mb{m}-{k}" for m, k in VARIANTS])
@pytest.mark.parametrize("arch", ARCHS)
def test_ranked_step_matches_reference_and_unsharded(arch, variant, tmp_path_factory):
    ranked = _ranked(arch, tmp_path_factory)[variant]
    r_metrics, r_grads, r_params = _reference(arch)[variant]
    u_metrics, u_grads, u_params = _unsharded(arch)[variant]
    kind = variant[1]
    undecided, moves = {}, 0.0
    for name, g in ranked["grads"].items():
        assert rel(g.numpy(), ref_leaf(r_grads, name)) <= 1e-5, name
        assert rel(g.numpy(), u_grads[name].numpy()) <= 1e-5, name
        mask = _undecided(g, ranked["stats"][name], kind)
        # the largest move of the compressed gradient the undecided
        # elements allow: one int8 code each, or the element itself (top-k)
        a = g.abs().double().numpy()[mask]
        moves += float(((float(ranked["stats"][name]) / 127.0) ** 2 * a.size) if kind == "int8"
                       else ((a + 1e-5 * float(g.abs().max())) ** 2).sum())
        path, layer = _reference_path(name)
        key = "/" + "/".join(path)
        if layer is None:
            undecided[key] = mask
        else:
            undecided.setdefault(key, {})[layer] = mask
    undecided = {k: np.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) else v
                 for k, v in undecided.items()}
    # the ranked step's grad norm is that of its whole gradient compressed
    comp = Compressor(kind)
    whole = comp.roundtrip(ranked["grads"], comp.leaf_stats(ranked["grads"]))
    norm = float(torch.sqrt(sum(torch.sum(t.double() ** 2) for t in whole.values())))
    assert rel(ranked["metrics"]["grad_norm"], norm) <= 1e-5
    for key in METRICS:
        for want in (r_metrics[key], u_metrics[key]):
            got = ranked["metrics"][key]
            if key == "grad_norm":                  # after compression
                assert abs(got - want) <= 1e-5 * abs(want) + moves ** 0.5, (got, want)
            else:
                assert rel(got, want) <= 1e-5, key
    _close_params(ranked["params"], r_params, undecided)
    _close_params(ranked["params"], u_params, undecided)
