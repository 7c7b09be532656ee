"""Tensor, sequence and expert parallelism across gloo ranks
(``repro_torch.dist.zero.ranked_lm``: one process a rank, ``DistComm``,
FSDP2 ZeRO-3 over "data"), held to the port's unsharded model.

starcoder2-3b's smoke (2 KV heads: gathered at M = 4) and
moonshot-v1-16b-a3b's (TP, SP and EP together, the shared experts over
ff) in float32 at 1 x 4 and 2 x 2, the MoE at a capacity factor (8.0)
that drops no pair.  Each rank checks that

* every parameter's local shard (FSDP's over "data" inside the rank's
  "model" shard) has the shape of its leaf's shard under ``param_specs``
  over both axes;
* between layers its stream is its shard (B/D, S/M, d) of the batch and
  the sequence.

Then, as ``test_torch_train_ranks.py`` holds meshes (``tests/_ranks.py``):
the step-0 loss and every gathered gradient within 1e-5 relative of the
unsharded step on the same global batch, three AdamW steps (metrics 1e-5,
parameters 1e-4), and checkpoints across meshes: 1 x 4 resumes the
unsharded model's checkpoint, 2 x 2 resumes 1 x 4's, and the unsharded
model resumes 2 x 2's, each resumed fourth step as the other took it.
"""
import pytest
import torch

import _ranks as R
from _train_parity import METRICS, rel
from repro_torch.models.model import CausalLM

ARCHS = ("starcoder2-3b", "moonshot-v1-16b-a3b")
MESHES = ((1, 4), (2, 2))          # in this order: 2 x 2 resumes 1 x 4's checkpoint
_RUNS: dict = {}

PROG = r"""
import math, sys, datetime
from pathlib import Path
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
sys.path.insert(0, "tests")
import _ranks as R
from repro_torch.dist.zero import ranked_lm
from repro_torch.models import transformer
from repro_torch.launch.mesh import make_lm_mesh
rank, world, addr, out, arch, data, model, resume = sys.argv[1:9]
rank, world, data, model, out = int(rank), int(world), int(data), int(model), Path(out)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
cfg = R.smoke_cfg(arch)
lm = ranked_lm(cfg, make_lm_mesh(data, model, "cpu"), seed=0)
place = lm.placement
sizes = place.rules["_axes"]
checked = 0
for name, p in lm.named_parameters():
    want = list(place.shapes[name])
    for i, ax in enumerate(place.specs[name]):
        if ax is not None:
            want[i] //= math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
    local = p.to_local() if isinstance(p, DTensor) else p
    assert tuple(local.shape) == tuple(want), (name, tuple(local.shape), want)
    checked += 1
seen = set()
block = transformer._block
def recording(blocks, xs, *args):
    seen.add(tuple(xs[0].shape))
    return block(blocks, xs, *args)
transformer._block = recording
res = R.trajectory(lm, cfg, out, f"ck_{data}x{model}", resume=resume, rank=rank,
                   ranks=world)
transformer._block = block
assert seen == {(R.BATCH // data, R.SEQ // model, cfg.d_model)}, seen
if rank == 0:
    res["checked"] = {"leaves": checked, "stream": sorted(seen)}
    torch.save(res, out / f"ranks_{data}x{model}.pt")
dist.destroy_process_group()
print("RANK_OK")
"""


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ranks")


def _runs(arch, out):
    """{"one": the unsharded trajectory, mesh: the ranked one} (every mesh
    run in order) and the unsharded model's step resumed from 2 x 2's
    checkpoint."""
    if arch not in _RUNS:
        cfg = R.smoke_cfg(arch)
        d = out / arch
        d.mkdir()
        runs = {"one": R.trajectory(CausalLM(cfg, device="cpu", seed=0), cfg, d, "ck_one")}
        resume = "ck_one"
        for mesh in MESHES:
            R.run_ranks(PROG, mesh[0] * mesh[1], d, arch, *mesh, resume, timeout=150)
            runs[mesh] = torch.load(d / f"ranks_{mesh[0]}x{mesh[1]}.pt", weights_only=False)
            resume = f"ck_{mesh[0]}x{mesh[1]}"
        runs["resumed_one"] = R.resumed_step(CausalLM(cfg, device="cpu", seed=None), cfg,
                                             d / resume)
        _RUNS[arch] = runs
    return _RUNS[arch]


def _close_metrics(got, want, what):
    for key in METRICS:
        assert rel(got[key], want[key]) <= 1e-5, (what, key, got[key], want[key])


def _close_params(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close_params(got[k], want[k], f"{path}/{k}")
    else:
        assert abs(got - want).max() <= 1e-4, path


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_and_stream_are_the_rules(arch, mesh, out):
    """Every rank checked every leaf's local shape and its stream's (the
    rank program asserts both); rank 0 reports what it checked."""
    runs = _runs(arch, out)
    checked = runs[mesh]["checked"]
    assert checked["leaves"] == len(runs["one"]["grads0"])
    cfg = R.smoke_cfg(arch)
    assert checked["stream"] == [(R.BATCH // mesh[0], R.SEQ // mesh[1], cfg.d_model)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_three_steps_match_one_process(arch, mesh, out):
    runs = _runs(arch, out)
    one, ranks = runs["one"], runs[mesh]
    assert rel(ranks["loss0"], one["loss0"]) <= 1e-5
    assert ranks["grads0"].keys() == one["grads0"].keys()
    for name, want in one["grads0"].items():
        assert rel(ranks["grads0"][name].numpy(), want.numpy()) <= 1e-5, name
    for step, (got, want) in enumerate(zip(ranks["steps"], one["steps"])):
        _close_metrics(got, want, f"step {step}")
    _close_metrics(ranks["last"][0], one["last"][0], "step 3")
    _close_params(ranks["params"], one["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_resume_across_meshes(arch, out):
    runs = _runs(arch, out)
    one = runs["one"]
    for mesh in MESHES:        # 1 x 4 from the unsharded model's, 2 x 2 from 1 x 4's
        _close_metrics(runs[mesh]["resumed_last"][0], one["last"][0], mesh)
        _close_params(runs[mesh]["resumed_params"], one["params"])
    metrics, params = runs["resumed_one"]            # unsharded from 2 x 2's
    _close_metrics(metrics[0], runs[MESHES[-1]]["last"][0], "one from 2 x 2")
    _close_params(params, runs[MESHES[-1]]["params"])
