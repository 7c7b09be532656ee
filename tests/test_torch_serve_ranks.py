"""Serving across gloo ranks (``launch.serve --data D --model M``:
``ranked_lm`` in each rank, heads, ff, vocab and experts split over
"model", the slots and requests over "data"), held to the unsharded port.

* Model level, float32, the MoE at a capacity factor (8.0) that drops no
  pair: a prefill over a batch of prompts split over "data" (its sequence
  split over "model") and three greedy decode steps (the stream whole on
  every rank) give logits within 1e-5 relative of the unsharded model's,
  every rank the same greedy tokens; each rank's cache holds its KV heads
  (all of them where they do not divide by M, ``cache_specs``) of its
  data row's slots.
* The launcher: the ranked engine's greedy tokens per request equal the
  one-process engine's (float32).
* Refusals: the ssm, hybrid, vlm and audio families across ranks name
  ROADMAP item 6 (audio: F6) before any rank starts; a mesh that cannot
  start (more ranks than cards) exits non-zero and serves nothing.
"""
import os
import subprocess
import sys

import pytest
import torch

import _ranks as R
from repro_torch.configs import get_smoke
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch import serve as launcher

PROG = r"""
import sys, datetime
import torch, torch.distributed as dist
sys.path.insert(0, "tests")
import _ranks as R
from repro_torch.dist.zero import ranked_lm
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models.model import CausalLM
rank, world, addr, arch, data, model = sys.argv[1:7]
rank, world, data, model = int(rank), int(world), int(data), int(model)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
cfg = R.smoke_cfg(arch)
lm = ranked_lm(cfg, make_lm_mesh(data, model, "cpu"), seed=0).requires_grad_(False)
one = CausalLM(cfg, device="cpu", seed=0).requires_grad_(False)
gen = torch.Generator().manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen)
row = lm.placement.data_rank
mine = toks[row * 4 // data:(row + 1) * 4 // data]
want, cache = one.prefill(mine, 40, torch.float32)
got, mycache = lm.prefill(mine, 40, torch.float32)
def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())
assert rel(got, want) <= 1e-5, rel(got, want)
kvh = cfg.n_kv_heads // model if cfg.n_kv_heads % model == 0 else cfg.n_kv_heads
for group in mycache.values():
    assert tuple(group["k"].shape[1:4]) == (4 // data, 40, kvh), group["k"].shape
nxt, mnxt = want.argmax(-1), got.argmax(-1)
for i in range(3):
    want, cache = one.decode_step(nxt, cache, 24 + i)
    got, mycache = lm.decode_step(mnxt, mycache, 24 + i)
    assert rel(got, want) <= 1e-5, (i, rel(got, want))
    nxt, mnxt = want.argmax(-1), got.argmax(-1)
    assert torch.equal(nxt, mnxt)
    same = [torch.empty_like(mnxt) for _ in range(model)]
    dist.all_gather(same, mnxt, group=lm.placement.mesh.get_group("model"))
    assert all(torch.equal(s, mnxt) for s in same)
dist.destroy_process_group()
print("RANK_OK")
"""

SERVE = ["--smoke", "--device", "cpu", "--dtype", "float32", "--requests", "4",
         "--slots", "2", "--prompt-len", "12", "--max-new", "4", "--max-len", "24"]


@pytest.mark.parametrize("arch,mesh", [("starcoder2-3b", (1, 4)), ("chatglm3-6b", (1, 2)),
                                       ("moonshot-v1-16b-a3b", (2, 2)),
                                       ("deepseek-moe-16b", (1, 4))],
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_ranked_prefill_and_decode_match_unsharded(arch, mesh):
    R.run_ranks(PROG, mesh[0] * mesh[1], arch, *mesh, timeout=150)


@pytest.mark.parametrize("arch,mesh", [("starcoder2-3b", (1, 4)), ("chatglm3-6b", (2, 2))],
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_ranked_engine_gives_the_unsharded_tokens(arch, mesh, capfd):
    one = launcher.main(["--arch", arch] + SERVE)
    ranked = launcher.main(["--arch", arch, "--data", str(mesh[0]), "--model",
                            str(mesh[1])] + SERVE)
    out = capfd.readouterr().out
    assert f"on a {mesh[0]} x {mesh[1]} mesh of ranks" in out and "served 4 requests" in out
    assert {r.rid: r.out_tokens for r in ranked} == {r.rid: r.out_tokens for r in one}
    assert all(len(r.out_tokens) == 4 for r in ranked)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b", "paligemma-3b"])
def test_ranked_serving_refuses_other_families(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6"):
        launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--data", "1",
                       "--model", "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6"):
        ranked_lm(get_smoke(arch), mesh=None)
    with pytest.raises(NotImplementedError, match="F6"):
        launcher.main(["--arch", "musicgen-large", "--smoke", "--device", "cpu",
                       "--data", "1", "--model", "2"])


def test_ranked_serving_that_cannot_start_exits_nonzero():
    if torch.cuda.device_count() >= 8:
        pytest.skip("this machine has 8 cards")
    env = dict(os.environ, PYTHONPATH=str(R.ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                           "--data", "2", "--model", "4", "--slots", "4"], env=env,
                          cwd=R.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "served" not in proc.stdout
