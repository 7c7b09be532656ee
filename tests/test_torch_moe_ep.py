"""Expert parallelism on the CPU: the port's ``moe_ffn_ep`` against the
reference's ``moe_ffn_ep`` (a ``shard_map`` with two all-to-alls), and the
port's distributed comm against its in-process one.

The reference runs in a subprocess with 8 fake host devices on its 4 x 2
("data", "model") mesh, as ``tests/progs/ep_moe.py`` does; its tokens are
sharded batch over "data" and sequence over "model", so the port's rank
(d, m) takes that device's (B/4, S/2) chunk: which pairs a capacity drops
depends on which tokens share a rank.  At capacity factor 1.0 pairs are
dropped (both packages), at 8.0 none.  Outputs, the aux loss and the
gradients of sum(out * w) + aux with respect to x, the router, the routed
experts and the shared experts agree within 1e-5 (float32).

This chunk layout (the batch over "data", the sequence over "model") is
the one a ranked model's MoE layers now see (``repro_torch.dist.tp``).
There the shared experts are tensor-parallel over ff: their leaves stay
whole (no rule of the reference names them), each rank reads 1/M of their
columns, the sequence is all-gathered before them and their partial sums
are reduce-scattered after; that case is held to the same reference
outputs and gradients.

A gloo world of 4 ranks (2 x 2) over ``DistComm`` gives ``LocalComm``'s
per-rank outputs, aux and gradients bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _ranks import ROOT, run_ranks
from repro_torch.dist.comm import LocalComm, Rank
from repro_torch.models import moe as PMoE
from repro_torch.models.mlp import mlp_ranks
from repro_torch.models.config import MoEConfig

D, M = 4, 2                          # the reference's EP mesh (ep_moe.py)
B, S, DM, FF = 8, 16, 64, 96
CFG = MoEConfig(n_experts=8, top_k=2, n_shared=1)

REF_PROG = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.models.moe import moe_ffn_ep
from repro.models.config import MoEConfig
from repro.dist.sharding import set_axis_sizes
out = sys.argv[1]
inp = dict(np.load(f"{out}/inputs.npz"))
mesh = jax.make_mesh((4, 2), ("data", "model"))
set_axis_sizes(mesh)
p = {k: jnp.asarray(inp[k]) for k in ("router", "up", "gate", "down", "shared_up",
                                       "shared_gate", "shared_down")}
x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])
res = {}
for cf in (1.0, 8.0):
    cfg = MoEConfig(n_experts=8, top_k=2, n_shared=1, capacity_factor=cf)
    def obj(p, x):
        o, aux = moe_ffn_ep(p, x, cfg, "swiglu", mesh, ("data",))
        return jnp.sum(o * w) + aux, (o, aux)
    with mesh:
        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(obj, argnums=(0, 1),
                                                             has_aux=True))(p, x)
    res[f"{cf}/out"], res[f"{cf}/aux"], res[f"{cf}/x"] = o, aux, gx
    for k, v in gp.items():
        res[f"{cf}/{k}"] = v
np.savez(f"{out}/ref.npz", **{k: np.asarray(v) for k, v in res.items()})
print("REF_OK")
"""


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=0.02: (rng.standard_normal(s) * scale).astype(np.float32)
    e = CFG.n_experts
    return {"router": f(DM, e, scale=0.006 * 30), "up": f(e, DM, FF), "gate": f(e, DM, FF),
            "down": f(e, FF, DM), "shared_up": f(DM, FF), "shared_gate": f(DM, FF),
            "shared_down": f(FF, DM), "x": f(B, S, DM, scale=1.0), "w": f(B, S, DM, scale=1.0)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_ref")
    np.savez(out / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REF_PROG, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "REF_OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(out / "ref.npz"))


def _chunk(r: int):
    """The reference device (d, m)'s slice of the (B, S, ...) tokens."""
    d, m = divmod(r, M)
    return slice(d * B // D, (d + 1) * B // D), slice(m * S // M, (m + 1) * S // M)


def _port_ep(inp: dict, cf: float, comm, ranks, stats=None, per_rank_leaves=False,
             tp_shared=False):
    """The port's EP over ``ranks`` (mesh ranks in ``comm``'s order) on the
    reference devices' chunks.  Returns (outputs, auxs, leaves): with
    ``per_rank_leaves`` every rank gets its own leaf tensors (gradients
    per rank), else one leaf per weight and for x, sliced per rank.  With
    ``tp_shared`` the shared experts run tensor-parallel over ff
    (``models.mlp.mlp_ranks``), the rank reading its 1/M of their ff
    columns."""
    cfg = dataclasses.replace(CFG, capacity_factor=cf)
    e_loc = cfg.n_experts // M
    full = {k: torch.tensor(v) for k, v in inp.items()}
    shared = {k: full[k].requires_grad_() for k in full if k != "w"}
    ps, xs, leaves = [], [], []
    for r in ranks:
        bs, ss = _chunk(r)
        lo = r % M * e_loc
        if per_rank_leaves:
            own = {k: full[k].detach().clone().requires_grad_() for k in shared}
            x = own["x"][bs, ss]
        else:
            own, x = shared, shared["x"][bs, ss]
        p = {k: own[k] for k in ("router", "shared_up", "shared_gate", "shared_down")}
        p.update({k: own[k][lo:lo + e_loc] for k in ("up", "gate", "down")})
        ps.append(p)
        xs.append(x)
        leaves.append(own)
    if not tp_shared:
        outs, auxs = PMoE.moe_ffn_ep(ps, xs, cfg, "swiglu", comm, stats=stats)
        return outs, auxs, leaves
    routed = [{k: v for k, v in p.items() if not k.startswith("shared_")} for p in ps]
    outs, auxs = PMoE.moe_ffn_ep(routed, xs, cfg, "swiglu", comm, stats=stats)
    cols = [slice(r % M * FF // M, (r % M + 1) * FF // M) for r in ranks]
    shared = [{"up": p["shared_up"][:, c], "gate": p["shared_gate"][:, c],
               "down": p["shared_down"][c]} for p, c in zip(ps, cols)]
    ranks = [Rank(comm, r % M, M) for r in ranks]
    sh = mlp_ranks(shared, xs, "swiglu", ranks, sp=True, split=True)
    return [o + t for o, t in zip(outs, sh)], auxs, leaves


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_ffn_ep_matches_reference(reference, cf):
    _check_against_reference(reference, cf, tp_shared=False)


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_ffn_ep_with_tp_shared_experts_matches_reference(reference, cf):
    _check_against_reference(reference, cf, tp_shared=True)


def _check_against_reference(reference, cf, tp_shared):
    inp = _inputs()
    stats = {}
    outs, auxs, (leaves, *_) = _port_ep(inp, cf, LocalComm(D, M), range(D * M), stats,
                                        tp_shared=tp_shared)
    w = torch.tensor(inp["w"])
    out = torch.zeros(B, S, DM)
    obj = auxs[0]                                # the same aux on every rank
    for r, o in enumerate(outs):
        bs, ss = _chunk(r)
        out[bs, ss] = o.detach()
        obj = obj + (o * w[bs, ss]).sum()
    obj.backward()
    np.testing.assert_allclose(out.numpy(), reference[f"{cf}/out"], atol=1e-5, rtol=0)
    assert all(torch.equal(a, auxs[0]) for a in auxs)
    assert abs(float(auxs[0].detach()) - float(reference[f"{cf}/aux"])) <= 1e-5
    for name in ("x", "router", "up", "gate", "down", "shared_up", "shared_gate",
                 "shared_down"):
        np.testing.assert_allclose(leaves[name].grad.numpy(), reference[f"{cf}/{name}"],
                                   atol=1e-5, rtol=0, err_msg=name)
    dropped = stats["dropped_send"] + stats["dropped_local"]
    assert stats["pairs"] == B * S * CFG.top_k
    if cf == 1.0:
        assert dropped > 0
        # the reference dropped too: its output is not its no-drop output
        assert np.abs(reference["1.0/out"] - reference["8.0/out"]).max() > 1e-3
    else:
        assert dropped == 0


GLOO_PROG = r"""
import sys, datetime
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, "tests")
import test_torch_moe_ep as T
from repro_torch.dist.comm import DistComm
rank, world, addr, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
for g in ([0, 1], [2, 3]):                      # every rank creates every group
    grp = dist.new_group(g)
    if rank in g:
        model = grp
res = T.run_rank(T._inputs(), DistComm(model), [rank])
np.savez(f"{out}/rank{rank}.npz", **res[0])
dist.destroy_process_group()
print("RANK_OK")
"""


def run_rank(inp, comm, ranks):
    """Per rank: output, aux and its own leaves' gradients of sum(out * w)
    + rank 0's aux (the aux is the same on every rank; counted once)."""
    outs, auxs, leaves = _port_ep(inp, 1.0, comm, ranks, per_rank_leaves=True)
    w = torch.tensor(inp["w"])
    obj = 0.0
    for r, o, a in zip(ranks, outs, auxs):
        bs, ss = _chunk(r)
        obj = obj + (o * w[bs, ss]).sum() + (a if r == 0 else 0.0 * a)
    obj.backward()
    return [{"out": o.detach().numpy(), "aux": a.detach().numpy(),
             **{k: v.grad.numpy() for k, v in own.items()}}
            for o, a, own in zip(outs, auxs, leaves)]


def test_gloo_ranks_equal_local_comm(tmp_path):
    """Two data rows of two model ranks; capacity factor 1.0 (drops)."""
    torch.set_num_threads(1)
    local = run_rank(_inputs(), LocalComm(2, M), range(2 * M))
    run_ranks(GLOO_PROG, 2 * M, tmp_path)
    for r in range(2 * M):
        got = np.load(tmp_path / f"rank{r}.npz")
        for key, want in local[r].items():
            assert np.array_equal(got[key], want), (r, key)
