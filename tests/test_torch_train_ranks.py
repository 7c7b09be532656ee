"""Training across ranks on the CPU: gloo worlds of four ranks on the
(data, model) meshes 2 x 2, 4 x 1 and 1 x 4 (``repro_torch.dist.zero``:
the batch and ZeRO-3 over "data"; tensor, sequence and expert parallelism
over "model"), held to the port's unsharded step on the same global batch
from the same seed.

deepseek-moe-16b's and chatglm3-6b's smoke configs in float32, the MoE at
a capacity factor (8.0) that drops no pair: with drops, which pairs drop
depends on which tokens share a rank.  Tolerances, as
``tests/_train_parity.py`` holds the port to the reference:

* the loss and every gradient (gathered whole, after
  ``Placement.sync_grads``) of one backward: 1e-5 relative (to the leaf's
  largest gradient).  This holds the gradient scale of every placement
  (split over "model", whole over it and summed over the data row, FSDP's
  mean over "data") and the global gradient norm;
* three AdamW steps: loss, ce, aux, grad norm and lr within 1e-5 relative
  at every step, parameters after the third within 1e-4 absolute (values
  of order 0.02);
* checkpoints: the ranks write one (gathered, by rank 0, in the
  reference's layout) after the third step, which an unsharded model
  resumes, and resume one that the unsharded model wrote; each resumed
  model's fourth step agrees with the uninterrupted other's within the
  same tolerances.

Each rank also checks that the step refuses microbatches and a
compressor across ranks.
"""
import numpy as np
import pytest
import torch

import _ranks as R
from _train_parity import METRICS, rel
from repro_torch.configs import get_smoke
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch import train as launcher
from repro_torch.models.model import CausalLM

MESHES = ((2, 2), (4, 1), (1, 4))
ARCHS = ("deepseek-moe-16b", "chatglm3-6b")
_RUNS: dict = {}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


def _one_card(arch, out):
    """The unsharded trajectory (its checkpoint in ``out/arch/ck_one``)."""
    if arch not in _RUNS:
        cfg = R.smoke_cfg(arch)
        d = out / arch
        d.mkdir(exist_ok=True)
        torch.manual_seed(0)
        _RUNS[arch] = R.trajectory(CausalLM(cfg, device="cpu", seed=0), cfg, d, "ck_one")
    return _RUNS[arch]


def _ranks(arch, mesh, out):
    """(the unsharded trajectory, the ranked one, an unsharded model's
    step after resuming the ranks' checkpoint)."""
    key = (arch, mesh)
    if key not in _RUNS:
        one = _one_card(arch, out)
        d, tag = out / arch, f"{mesh[0]}x{mesh[1]}"
        R.run_ranks(R.TRAIN_PROG, mesh[0] * mesh[1], d, arch, *mesh, timeout=150)
        ranks = torch.load(d / f"ranks_{tag}.pt", weights_only=False)
        cfg = R.smoke_cfg(arch)
        resumed = R.resumed_step(CausalLM(cfg, device="cpu", seed=None), cfg, d / f"ck_{tag}")
        _RUNS[key] = (one, ranks, resumed)
    return _RUNS[key]


def _close_params(got: dict, want: dict, atol: float, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close_params(got[k], want[k], atol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=path)


def _close_metrics(got: dict, want: dict, what):
    for key in METRICS:
        assert rel(got[key], want[key]) <= 1e-5, (what, key, got[key], want[key])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_one_card(arch, mesh, out):
    one, ranks, _ = _ranks(arch, mesh, out)
    assert rel(ranks["loss0"], one["loss0"]) <= 1e-5
    assert ranks["grads0"].keys() == one["grads0"].keys()
    for name, want in one["grads0"].items():
        assert rel(ranks["grads0"][name].numpy(), want.numpy()) <= 1e-5, name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_one_card(arch, mesh, out):
    one, ranks, _ = _ranks(arch, mesh, out)
    for step, (got, want) in enumerate(zip(ranks["steps"], one["steps"])):
        _close_metrics(got, want, f"step {step}")
    _close_metrics(ranks["last"][0], one["last"][0], "step 3")
    _close_params(ranks["params"], one["params"], 1e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_resume_across_meshes(arch, mesh, out):
    """The ranks resume the unsharded model's checkpoint, and the
    unsharded model the ranks': each takes the fourth step as the other
    took it uninterrupted."""
    one, ranks, (metrics, params) = _ranks(arch, mesh, out)
    _close_metrics(ranks["resumed_last"][0], one["last"][0], "ranks from one card")
    _close_params(ranks["resumed_params"], one["params"], 1e-4)
    _close_metrics(metrics[0], ranks["last"][0], "one card from the ranks")
    _close_params(params, ranks["params"], 1e-4)


def test_refusals_before_any_rank_starts():
    """The families not ported across ranks, a batch that does not split
    over the data ranks, and more ranks than visible cards."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ranked_lm(get_smoke("zamba2-2.7b"), mesh=None)
    with pytest.raises(ValueError, match="does not split"):
        launcher.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                       "--data", "2", "--model", "2", "--batch", "5"])
    if torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match="cards"):
            launcher.main(["--arch", "deepseek-moe-16b", "--smoke", "--data", "2",
                           "--model", "4", "--batch", "8"])


def test_spawn_ranks_returns_each_ranks_result_and_stops_a_stuck_or_failed_run():
    """The launcher's one rank runner: results in rank order; a rank that
    misses a collective fails the run at the timeout, and a rank that
    raises fails it (the first error seen may be its peer's, cut off),
    with every rank stopped either way."""
    assert launcher.spawn_ranks(R.rank_and_size, 1, 2, "cpu", timeout=120) == [(0, 2), (1, 2)]
    with pytest.raises(TimeoutError, match="still running"):
        launcher.spawn_ranks(R.stall_on_rank_1, 2, 1, "cpu", timeout=10)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        launcher.spawn_ranks(R.fail_on_rank_1, 2, 1, "cpu", timeout=120)


def test_launcher_trains_across_gloo_ranks(capfd):
    """``launch.train`` with ``--data 2 --model 2`` on the CPU: four
    spawned gloo ranks train chatglm3-6b's smoke (bf16 compute) for two
    steps; rank 0 prints the mesh and each rank's losses are finite, and
    step 0's is the one-process run's within 1e-3 relative (the partial
    sums over "model" round in bf16)."""
    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "32", "--log-every", "1"]
    ranked = launcher.main(argv + ["--data", "2", "--model", "2"])
    assert "mesh=2x2" in capfd.readouterr().out
    one = launcher.main(argv)
    assert len(ranked) == 2 and np.all(np.isfinite(ranked))
    assert rel(ranked[0], one[0]) <= 1e-3
