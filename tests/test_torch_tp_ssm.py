"""The ssm (rwkv6-3b) and hybrid (zamba2-2.7b) families across ranks on the
CPU: tensor and sequence parallelism over "model" (``repro_torch.dist.tp``)
with every rank of a (data D, model M) mesh in one process (``LocalComm``)
at 1 x 2, 2 x 2 and 1 x 4, and one 2 x 2 world of gloo ranks.

* rwkv6: ``tmix.wk``/``wv`` on their columns (the rank's heads), ``wo`` on
  its rows, ``cmix.wk`` on its ff columns and ``cmix.wv`` on its output
  columns; the WKV on the rank's heads of the gathered sequence.  At M = 8
  the smoke's 4 heads of 16 columns are cut in two: the projections are
  gathered and each rank computes every head.  The state holds the rank's
  heads (``cache_specs``).
* zamba2: every Mamba2 layer whole on the gathered sequence (no rule names
  a Mamba2 leaf); the shared block over heads and ff, its LoRA whole; in
  decode each rank steps its heads of the ``ssm`` state, the gated norm's
  sum of squares and ``out_proj`` summed over "model".
* Parity (``tests/_tp_parity.py``), float32, at S 64 (rwkv6's chunked WKV
  and Mamba2's chunked SSD run): logits, loss and every gradient within
  1e-5 of the unsharded port and of ``jax.value_and_grad`` on the
  reference (zamba2's LoRA and ``dt_bias`` drawn where the reference's
  gradient is finite, F8); prefill and decode logits within 1e-5 of the
  unsharded port, caches shaped as ``cache_specs`` places them.
* gloo, 2 x 2 (``ranked_lm``: FSDP2 over "data" per Mamba2 layer, the
  shared block and LoRA in the root's unit): zamba2's step-0 loss and
  gathered gradients within 1e-5 of the unsharded model's, three AdamW
  steps, a checkpoint of the unsharded model resumed, and a prefill and
  decode steps served from the trained ranks equal to the unsharded
  model's within 1e-5.
"""
import pytest
import torch

import _ranks as R
import _tp_parity as T
from _train_parity import METRICS, rel
from repro_torch.configs import get_smoke
from repro_torch.dist import tp
from repro_torch.dist.comm import LocalComm
from repro_torch.models import rwkv6
from repro_torch.models.model import CausalLM

ARCHS = ("rwkv6-3b", "zamba2-2.7b")
MESHES = ((1, 2), (2, 2), (1, 4))
IDS = [f"{d}x{m}" for d, m in MESHES]
S = 64


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_parameter_shapes_are_the_spec_shards(arch, mesh):
    assert T.check_local_shapes(arch, mesh) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_unsharded_and_reference(arch, mesh, monkeypatch):
    T.check_train(arch, mesh, S, monkeypatch)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unsharded(arch, mesh):
    T.check_serving(arch, mesh)


def test_rwkv6_heads_cut_by_the_column_shards(monkeypatch):
    """M = 8 on the smoke's 4 heads of 16 columns: each rank holds 8
    columns of ``wk``/``wv``; the projections are gathered, every head is
    computed, and the state holds every head."""
    modes = []
    orig = rwkv6._mode

    def recording(p, d, head_dim, r):
        mode = orig(p, d, head_dim, r)
        if r.M > 1:                         # the ranks, not the unsharded model
            modes.append(mode)
        return mode

    monkeypatch.setattr(rwkv6, "_mode", recording)
    T.check_train("rwkv6-3b", (1, 8), S, monkeypatch)
    caches = T.check_serving("rwkv6-3b", (1, 8))
    assert set(modes) == {"cols"}
    assert caches[0]["wkv"].shape[2] == 4


def test_state_heads_split_and_whole():
    """The recurrent states hold the rank's heads where they divide by M."""
    for arch, m, want in (("rwkv6-3b", 2, 2), ("rwkv6-3b", 8, 4), ("zamba2-2.7b", 4, 2),
                          ("zamba2-2.7b", 8, 1), ("zamba2-2.7b", 3, 8)):
        cfg = T.f32(get_smoke(arch))
        if cfg.family == "hybrid" and cfg.n_heads % m:
            with pytest.raises(NotImplementedError, match="query heads do not split"):
                tp.check_tp(cfg, m)
            continue
        ranks = tp.local_ranks(cfg, LocalComm(1, m), seed=None, device="meta")
        leaf = "wkv" if arch == "rwkv6-3b" else "ssm"
        assert ranks[0].init_cache(2, 8, torch.float32)[leaf].shape[2] == want, (arch, m)


PROG = r"""
import sys, datetime
from pathlib import Path
import torch, torch.distributed as dist
sys.path.insert(0, "tests")
import _ranks as R
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models.model import CausalLM
rank, world, addr, out, arch, data, model = sys.argv[1:8]
rank, world, data, model, out = int(rank), int(world), int(data), int(model), Path(out)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
cfg = R.smoke_cfg(arch)
lm = ranked_lm(cfg, make_lm_mesh(data, model, "cpu"), seed=0)
res = R.trajectory(lm, cfg, out, f"ck_{data}x{model}", resume="ck_one", rank=rank,
                   ranks=world)
# serve from the trained ranks: the unsharded model loads their checkpoint
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import load_params
lm.requires_grad_(False)
one = CausalLM(cfg, device="cpu", seed=None).requires_grad_(False)
trees, _ = CheckpointStore(str(out / f"ck_{data}x{model}")).restore_trees(R.STEPS)
load_params(one, trees["params"])
gen = torch.Generator().manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
row = lm.placement.data_rank
mine = toks[row * 4 // data:(row + 1) * 4 // data]
# the ranks' parameters are the ones after step STEPS + 1: reload the checkpoint's
from repro_torch.launch.train import restore_checkpoint
from repro_torch.optim.adamw import init_state
restore_checkpoint(CheckpointStore(str(out / f"ck_{data}x{model}")), R.STEPS, lm,
                   init_state(dict(lm.named_parameters())))
want, cache = one.prefill(mine, 40, torch.float32)
got, mycache = lm.prefill(mine, 40, torch.float32)
errs = [float((got - want).abs().max() / want.abs().max())]
nxt, mnxt = want.argmax(-1), got.argmax(-1)
for i in range(3):
    want, cache = one.decode_step(nxt, cache, 24 + i)
    got, mycache = lm.decode_step(mnxt, mycache, 24 + i)
    errs.append(float((got - want).abs().max() / want.abs().max()))
    assert torch.equal(nxt, mnxt)
    nxt, mnxt = want.argmax(-1), got.argmax(-1)
assert max(errs) <= 1e-5, errs
if rank == 0:
    res["serve_errs"] = errs
    torch.save(res, out / f"ranks_{data}x{model}.pt")
dist.destroy_process_group()
print("RANK_OK")
"""


@pytest.fixture(scope="module")
def zamba_runs(tmp_path_factory):
    cfg = R.smoke_cfg("zamba2-2.7b")
    out = tmp_path_factory.mktemp("tp_ssm")
    one = R.trajectory(CausalLM(cfg, device="cpu", seed=0), cfg, out, "ck_one")
    R.run_ranks(PROG, 4, out, "zamba2-2.7b", 2, 2, timeout=150)
    return one, torch.load(out / "ranks_2x2.pt", weights_only=False)


def _close_params(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close_params(got[k], want[k], f"{path}/{k}")
    else:
        assert abs(got - want).max() <= 1e-4, path


def test_zamba2_trains_resumes_and_serves_across_gloo_ranks(zamba_runs):
    one, ranks = zamba_runs
    assert rel(ranks["loss0"], one["loss0"]) <= 1e-5
    assert ranks["grads0"].keys() == one["grads0"].keys()
    for name, want in one["grads0"].items():
        assert rel(ranks["grads0"][name].numpy(), want.numpy()) <= 1e-5, name
    for got, want in zip(ranks["steps"] + ranks["last"], one["steps"] + one["last"]):
        for key in METRICS:
            assert rel(got[key], want[key]) <= 1e-5, key
    _close_params(ranks["params"], one["params"])
    for key in METRICS:
        assert rel(ranks["resumed_last"][0][key], one["last"][0][key]) <= 1e-5, key
    _close_params(ranks["resumed_params"], one["params"])
    assert max(ranks["serve_errs"]) <= 1e-5
