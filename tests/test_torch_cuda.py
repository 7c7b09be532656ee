"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no NVIDIA GPU.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(the kernels build into build/repro_torch/ at first use).  Tolerances:
1e-12 in float64 and 1e-5 in float32 on values of order 0.1 — the kernels
sum in another order than the plain versions.  Collision outputs are
compared at fluid slots; K1's rw_only mode bit for bit.  K3 (flash
attention) on unit-normal inputs, element by element within
``kernels.flash.error_bound``: 1e-5 in float32;
in bfloat16 2**-7 (|plain| + P |v|), one bf16 ulp of each output plus
K3's bf16 rounding of p in p.v, bounded by the same attention over |v|.
The bf16 cases at hd 64/80/128/256 run the Hopper kernel (128-row blocks,
128-key tiles, 64 at hd 256; at hd 80, zamba2's, a 64-column chunk and a
16-column tail chunk), so the shapes straddle those edges too; float32
runs the FMA kernel (64-row blocks, 64-key tiles).  The moe, ssm and hybrid smoke
models on the card against the same weights on the CPU: greedy tokens
equal, prefill logits within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import collision as C
from repro_torch.core.boundary import BoundarySpec
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.core.lattice import get_lattice
from repro_torch.core.tiling import SOLID, tile_geometry
from repro_torch.data.geometry import duct_wrap, random_spheres
from repro_torch.kernels import collide as k2
from repro_torch.kernels import flash as k3
from repro_torch.kernels import stream_collide as k1
from repro_torch.kernels.nebb_pass import (BoundaryNodes, nebb_boundary_pass,
                                           nebb_boundary_pass_ref)

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
VARIANTS = [(m, fl, force) for m in (C.LBGK, C.LBMRT)
            for fl in (C.INCOMPRESSIBLE, C.QUASI_COMPRESSIBLE)
            for force in (None, (1e-4, -2e-4, 3e-4))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _packed(dev, dtype, periodic=(False,) * 3, seed=0):
    g = random_spheres(box=16, porosity=0.6, diameter=8, seed=1)
    if not any(periodic):
        g = duct_wrap(g)
    tiling = tile_geometry(g, 4)
    t, n = tiling.num_tiles, 64
    types = np.full((t + 1, n), SOLID, np.uint8)
    types[:t] = tiling.node_types
    f = np.zeros((t + 1, 19, n))
    f[:t] = np.random.default_rng(seed).uniform(0.02, 0.1, (t, 19, n))
    nbrs = k1.build_neighbor_table(tiling, periodic)
    return (torch.as_tensor(f, dtype=dtype, device=dev),
            torch.as_tensor(types, device=dev),
            torch.as_tensor(nbrs, device=dev))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model,fluid,force", VARIANTS)
def test_k2_matches_plain(dev, dtype, model, fluid, force):
    f, types, _ = _packed(dev, dtype)
    fq = f[:-1].movedim(0, 1).contiguous()
    solid = types[:-1] == SOLID
    lat, cfg = get_lattice("D3Q19"), C.CollisionConfig(model, fluid, 0.7)
    before = k2.collide_tiles.launches
    got = k2.collide_tiles(fq, solid, lat, cfg, force)
    assert k2.collide_tiles.launches == before + 1
    want = k2.collide_tiles_ref(fq, solid, lat, cfg, force)
    fluid_slots = ~solid[None].expand_as(fq)
    assert float((got - want).abs()[fluid_slots].max()) <= TOL[dtype]
    assert not got[:, solid].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", k1.MODES)
@pytest.mark.parametrize("model,fluid,force", VARIANTS[::3])
def test_k1_matches_plain(dev, dtype, mode, model, fluid, force):
    for periodic in ((False,) * 3, (True,) * 3):
        f, types, nbrs = _packed(dev, dtype, periodic)
        args = (f, types, nbrs, get_lattice("D3Q19"),
                C.CollisionConfig(model, fluid, 0.7), 4, force, mode)
        got = k1.stream_collide_tiles(*args)
        want = k1.stream_collide_tiles_ref(*args)
        mask = (types != SOLID)[:, None, :].expand_as(f) if mode == "full" \
            else torch.ones_like(f, dtype=torch.bool)
        assert float((got - want).abs()[mask].max()) <= TOL[dtype]
        assert not got[-1].any()


RW_CASES = ([(dtype, q, 4, t, None) for dtype in (torch.float32, torch.float64)
             for q in (9, 19) for t in (1, 7, 133, 2049)]
            # n = 8; f alone offset by one element from a 16-byte boundary
            # (aligned unlike out: the register design); f and out both
            # offset (the ring, with a head and a tail under 16 bytes)
            + [(dtype, 19, a, t, view) for dtype in (torch.float32, torch.float64)
               for a, t, view in ((2, 133, None), (4, 133, "f"), (4, 2049, "f"),
                                  (4, 133, "both"), (4, 2049, "both"))])


@pytest.mark.parametrize("dtype,q,a,t,view", RW_CASES)
def test_k1_rw_only_copies_rows_exactly(dev, dtype, q, a, t, view):
    n = a ** 3
    size = (t + 1) * q * n
    vals = np.random.default_rng(t).uniform(-1.0, 1.0, size)
    vals[:4] = (-0.0, np.inf, np.nan, 1e-310)        # bits, not values
    f = torch.as_tensor(vals, dtype=dtype, device=dev)
    out = torch.full((size + 1,), float("nan"), dtype=dtype, device=dev)
    if view is not None:
        f = torch.cat([f[:1], f])[1:]                 # storage offset of one element
    out = out[1:] if view == "both" else out[:-1]
    f, out = f.view(t + 1, q, n), out.view(t + 1, q, n)
    if view is not None:
        assert f.data_ptr() % 16 == f.element_size()
    lat = get_lattice("D3Q19" if q == 19 else "D2Q9")
    types = torch.full((t + 1, n), SOLID, dtype=torch.uint8, device=dev)
    nbrs = torch.full((t, 27), t, dtype=torch.int32, device=dev)
    before = k1.stream_collide_tiles.launches
    got = k1.stream_collide_tiles(f, types, nbrs, lat, C.CollisionConfig(), a,
                                  mode="rw_only", out=out)
    torch.cuda.synchronize()
    assert k1.stream_collide_tiles.launches == before + 1
    assert got.data_ptr() == out.data_ptr()
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(out[:t].view(bits), f[:t].view(bits))
    assert bool(torch.isnan(out[t]).all())


def test_k1_rejects_what_it_cannot_take(dev):
    f, types, nbrs = _packed(dev, torch.float64)
    lat, cfg = get_lattice("D3Q19"), C.CollisionConfig()
    with pytest.raises(TypeError):
        k1.stream_collide_tiles(f.half(), types, nbrs, lat, cfg)
    with pytest.raises(TypeError):
        k1.stream_collide_tiles(f, types.int(), nbrs, lat, cfg)
    with pytest.raises(ValueError):
        k1.stream_collide_tiles(f, types, nbrs.cpu(), lat, cfg)
    with pytest.raises(ValueError):
        k1.stream_collide_tiles(f, types, nbrs, lat, cfg, out=f)


def test_fused_engine_matches_gather_with_k2(dev):
    g = duct_wrap(random_spheres(box=32, porosity=0.6, diameter=8, seed=1))
    from repro_torch.launch.lbm import _Z_FLOW

    kw = dict(dtype="float64", boundaries=_Z_FLOW,
              collision=C.CollisionConfig(C.LBMRT, C.QUASI_COMPRESSIBLE, 0.8))
    e_f = SparseTiledLBM(g, LBMConfig(backend="fused", **kw))
    e_g = SparseTiledLBM(g, LBMConfig(backend="gather", use_kernel=True,
                                      layout_scheme="paper", **kw))
    k1.stream_collide_tiles.launches = k2.collide_tiles.launches = 0
    e_f.run(10)
    e_g.run(10)
    assert k1.stream_collide_tiles.launches == 10
    assert k2.collide_tiles.launches == 10
    fluid = ~e_f._solid[None]
    diff = (e_f.backend.canonical(e_f.f) - e_g.backend.canonical(e_g.f)).abs()
    assert float(diff[fluid.expand_as(diff)].max()) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", [C.LBGK, C.LBMRT])
@pytest.mark.parametrize("periodic", [(False,) * 3, (True,) * 3])
def test_k1_over_replicated_tiles_equals_single_launches(dev, dtype, model,
                                                         periodic):
    """The ensembles' launch: K1 over 3*T tiles with the replicated tables
    is bit for bit three single-replica launches, and within tolerance of
    its plain version on the same tables."""
    g = random_spheres(box=16, porosity=0.6, diameter=8, seed=1)
    if not any(periodic):
        g = duct_wrap(g)
    cfg = LBMConfig(backend="fused", periodic=periodic,
                    collision=C.CollisionConfig(model, tau=0.7),
                    dtype="float64" if dtype == torch.float64 else "float32")
    eng = SparseTiledLBM(g, cfg, device=dev)
    types, nbrs, _ = eng.backend._ensemble_tables(3)
    t = eng.tiling.num_tiles
    singles = [_packed(dev, dtype, periodic, seed=i) for i in range(3)]
    f = torch.cat([x[0][:t] for x in singles] + [singles[0][0][t:]])
    args = (eng.lat, cfg.collision)
    got = k1.stream_collide_tiles(f, types, nbrs, *args)
    for i, (fi, ti, ni) in enumerate(singles):
        assert torch.equal(got[i * t:(i + 1) * t], k1.stream_collide_tiles(fi, ti, ni, *args)[:t])
    want = k1.stream_collide_tiles_ref(f, types, nbrs, *args)
    fluid = (types != SOLID)[:, None, :].expand_as(f)
    assert float((got - want).abs()[fluid].max()) <= TOL[dtype]
    assert not got[-1].any()


def test_fused_ensemble_matches_single_engines(dev):
    """One K1 launch per ensemble step over 3*T tiles, with the replicated
    NEBB pass: each replica within 1e-12 of a single engine."""
    from repro_torch.launch.lbm import _Z_FLOW

    g = duct_wrap(random_spheres(box=32, porosity=0.6, diameter=8, seed=1))
    cfg = LBMConfig(backend="fused", dtype="float64", boundaries=_Z_FLOW)
    eng = SparseTiledLBM(g, cfg, device=dev)
    ens = eng.ensemble(3)
    feq = eng._initial_feq()
    singles = []
    for b in range(3):
        single = SparseTiledLBM(g, cfg, device=dev)
        single.f = single.backend.initial_state(feq * (1.0 + 0.01 * (b + 1)))
        ens.set_replica(b, feq * (1.0 + 0.01 * (b + 1)))
        singles.append(single)
    k1.stream_collide_tiles.launches = 0
    ens.run(10)
    assert k1.stream_collide_tiles.launches == 10
    fluid = ~eng._solid[None]
    for b, single in enumerate(singles):
        single.run(10)
        want = single.backend.canonical(single.f)
        diff = (ens.replica_canonical(b) - want).abs()
        assert float(diff[fluid.expand_as(diff)].max()) <= 1e-12


def test_sim_service_on_the_card_matches_the_cpu(dev):
    """A fused float64 service on the card (K1 once per group step) gives
    the CPU service's results to 1e-12."""
    from repro_torch import obs
    from repro_torch.launch.lbm import _Z_FLOW
    from repro_torch.sim import SimService

    g = duct_wrap(random_spheres(box=32, porosity=0.6, diameter=8, seed=1))
    cfg = LBMConfig(backend="fused", dtype="float64", boundaries=_Z_FLOW)
    results = {}
    for device in ("cpu", dev):
        svc = SimService(slots=2, device=device)
        for steps in (6, 9, 4):
            svc.submit(g, cfg, steps=steps, probes=((10, 20, 1),))
        rec = obs.SpanRecorder()
        k1.stream_collide_tiles.launches = 0
        with obs.use(trace=rec):
            svc.run()
        if device is dev:
            assert k1.stream_collide_tiles.launches == len(rec.find("sim.group.step"))
        results[str(device)] = [s.result for s in sorted(svc.finished,
                                                         key=lambda s: s.sid)]
    for a, b in zip(results["cpu"], results[str(dev)]):
        assert a["steps"] == b["steps"]
        assert abs(a["mass"] - b["mass"]) <= 1e-12 * abs(a["mass"])
        assert abs(a["mean_speed"] - b["mean_speed"]) <= 1e-12
        assert abs(a["probes"][0]["rho"] - b["probes"][0]["rho"]) <= 1e-12


# ---------------------------------------------------------------- NEBB pass
NORMALS = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]


def _nebb_specs(kind):
    """One spec on each of the six axis normals: a velocity along the
    normal with a part across it, or a pressure."""
    if kind == "velocity":
        return tuple(BoundarySpec("velocity", nrm, velocity=tuple(
            0.02 * c + 0.001 * (a + 1) for a, c in enumerate(nrm))) for nrm in NORMALS)
    return tuple(BoundarySpec("pressure", nrm, rho=1.0 + 0.01 * i)
                 for i, nrm in enumerate(NORMALS))


def _nebb_tables(dev, t, nodes, seed, q=19, n=64):
    """Random node tables over one replica's T tiles: distinct (tile, slot)
    pairs, spec indices 0..5, sources anywhere in the replica's rows."""
    rng = np.random.default_rng(seed)
    node = np.sort(rng.choice(t * n, nodes, replace=False))
    return BoundaryNodes(tiles=(node // n).astype(np.int32),
                         slots=(node % n).astype(np.int32),
                         spec=rng.integers(0, 6, nodes).astype(np.uint8),
                         src=rng.integers(0, t * q * n, (q, nodes)).astype(np.int32),
                         num_tiles=t).to(dev)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["velocity", "pressure"])
@pytest.mark.parametrize("model,fluid,force", VARIANTS)
def test_nebb_kernel_matches_plain(dev, dtype, kind, model, fluid, force):
    """The NEBB kernel against its plain version, one launch each, on a
    single state and on 4 replicas: every slot within TOL (slots off the
    tables keep the values K1 left), and each replica's rows bit for bit a
    launch over that replica alone, so its offset is its own."""
    t, nodes = 50, 1500
    lat, cfg = get_lattice("D3Q19"), C.CollisionConfig(model, fluid, 0.7)
    specs, bc = _nebb_specs(kind), _nebb_tables(dev, t, nodes, seed=len(kind))
    rng = np.random.default_rng(7)
    f = torch.as_tensor(rng.uniform(0.02, 0.1, (4 * t + 1, 19, 64)), dtype=dtype, device=dev)
    k1_out = torch.as_tensor(rng.uniform(0.02, 0.1, f.shape), dtype=dtype, device=dev)
    f[-1] = k1_out[-1] = 0.0
    for b in (1, 4):
        rows = lambda x: torch.cat([x[:b * t], x[-1:]])  # noqa: E731
        fb, ob = rows(f), rows(k1_out)
        before = nebb_boundary_pass.launches
        got = nebb_boundary_pass(fb, ob.clone(), lat, cfg, force, specs, bc)
        assert nebb_boundary_pass.launches == before + 1
        want = nebb_boundary_pass_ref(fb, ob.clone(), lat, cfg, force, specs, bc)
        assert float((got - want).abs().max()) <= TOL[dtype]
        touched = torch.zeros(b * t + 1, 64, dtype=torch.bool, device=dev)
        for r in range(b):
            touched[bc.tiles.long() + r * t, bc.slots.long()] = True
        touched = touched[:, None, :].expand_as(got)
        assert torch.equal(got[~touched], ob[~touched])
        assert bool((got[touched] != ob[touched]).all())
    for r in range(4):
        one = lambda x: torch.cat([x[r * t:(r + 1) * t], x[-1:]])  # noqa: E731
        single = nebb_boundary_pass(one(f), one(k1_out), lat, cfg, force, specs, bc)
        assert torch.equal(got[r * t:(r + 1) * t], single[:t])


def test_nebb_kernel_on_sharded_slabs(dev):
    """Each slab of ``ShardedLBM`` with boundary nodes runs the kernel over
    its own tables: one launch, within 1e-12 of the plain version on the
    slab's K1 output (MRT, quasi-compressible, float64)."""
    from repro_torch.dist.lbm import ShardedLBM
    from repro_torch.launch.lbm import _Z_FLOW

    g = duct_wrap(random_spheres(box=32, porosity=0.6, diameter=8, seed=1))
    cfg = LBMConfig(backend="fused", dtype="float64", boundaries=_Z_FLOW,
                    collision=C.CollisionConfig(C.LBMRT, C.QUASI_COMPRESSIBLE, 0.8))
    eng = ShardedLBM(g, cfg, slabs=4, devices=dev.type)
    eng.run(3)
    slabs = [(b, f) for b, f in zip(eng.backends, eng.f) if b._bc is not None]
    assert 0 < len(slabs) < 4
    for b, f in slabs:
        out = b.stream_collide(f)
        want = nebb_boundary_pass_ref(f, out.clone(), b.lat, cfg.collision, cfg.force,
                                      b._specs, b._bc)
        before = nebb_boundary_pass.launches
        b.boundary_pass(f, out)
        assert nebb_boundary_pass.launches == before + 1
        assert float((out - want).abs().max()) <= 1e-12


def test_nebb_pass_launches_once_a_step(dev):
    """The main path goes through the kernel: one launch a step of an
    engine and of an ensemble (every replica in one), none without an open
    boundary."""
    from repro_torch.launch.lbm import _Z_FLOW

    g = duct_wrap(random_spheres(box=32, porosity=0.6, diameter=8, seed=1))
    eng = SparseTiledLBM(g, LBMConfig(backend="fused", dtype="float64",
                                      boundaries=_Z_FLOW), device=dev)
    ens = eng.ensemble(3)
    periodic = SparseTiledLBM(random_spheres(box=32, porosity=0.6, diameter=8, seed=1),
                              LBMConfig(backend="fused", periodic=(True,) * 3), device=dev)
    nebb_boundary_pass.launches = k1.stream_collide_tiles.launches = 0
    eng.run(5)
    ens.run(4)
    periodic.run(2)
    assert k1.stream_collide_tiles.launches == 11
    assert nebb_boundary_pass.launches == 9


def test_nebb_kernel_rejects_what_it_cannot_take(dev):
    t = 10
    lat, cfg = get_lattice("D3Q19"), C.CollisionConfig()
    bc, specs = _nebb_tables(dev, t, 100, seed=0), _nebb_specs("pressure")
    f = torch.rand(t + 1, 19, 64, dtype=torch.float64, device=dev)
    out = torch.rand_like(f)
    with pytest.raises(TypeError):
        nebb_boundary_pass(f.half(), out.half(), lat, cfg, None, specs, bc)
    with pytest.raises(ValueError):
        nebb_boundary_pass(f, f, lat, cfg, None, specs, bc)
    with pytest.raises(TypeError):
        nebb_boundary_pass(f, out, lat, cfg, None, specs,
                           dataclasses.replace(bc, src=bc.src.long()))
    with pytest.raises(ValueError):
        nebb_boundary_pass(f[:-1], out[:-1], lat, cfg, None, specs, bc)
    with pytest.raises(ValueError):
        nebb_boundary_pass(f, out, lat, cfg, None, specs + specs, bc)


def _sharded_vs_single(dev, backend, devices, slabs=None):
    """The slab-sharded engine (K1 or K2 once per slab per step) against
    the single engine on the card: owned tiles within 1e-12 in float64
    after 10 steps, with NEBB inlet and outlet."""
    from repro_torch.dist.lbm import ShardedLBM
    from repro_torch.launch.lbm import _Z_FLOW

    g = duct_wrap(random_spheres(box=32, porosity=0.6, diameter=8, seed=1))
    kw = dict(backend=backend, dtype="float64", boundaries=_Z_FLOW)
    if backend == "gather":
        kw.update(use_kernel=True, layout_scheme="paper")
    cfg = LBMConfig(**kw)
    single = SparseTiledLBM(g, cfg)
    eng = ShardedLBM(g, cfg, slabs=slabs, devices=devices)
    single.run(10)
    k1.stream_collide_tiles.launches = k2.collide_tiles.launches = 0
    eng.run(10)
    counted = (k1.stream_collide_tiles if backend == "fused" else k2.collide_tiles)
    assert counted.launches == eng.plan.n_dev * 10
    want = single.backend.canonical(single.f)
    for d, slab_dev, b, f in zip(eng.slab_ids, eng.devices, eng.backends, eng.f):
        rows, g_rows = eng.plan.owned_rows(d, single.tiling)
        g_rows = torch.as_tensor(g_rows, device=dev)
        got = b.canonical(f)[:, torch.as_tensor(rows, device=slab_dev)].to(dev)
        diff = (got - want[:, g_rows]).abs()
        fluid = ~single._solid[g_rows][None].expand_as(diff)
        assert float(diff[fluid].max()) <= 1e-12, d


@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("backend", ["fused", "gather"])
def test_sharded_engine_on_the_card_matches_single_engine(dev, backend, slabs):
    """Every slab on the one card."""
    _sharded_vs_single(dev, backend, None, slabs)


def _cards() -> int:
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    return cards


@pytest.mark.parametrize("per_card", [1, 2])
@pytest.mark.parametrize("backend", ["fused", "gather"])
def test_sharded_engine_across_cards_matches_single_engine(dev, backend, per_card):
    """Slabs on every visible card of one process (``make_host_mesh``), the
    single engine on the first: each slab's kernels launch on its own card
    whichever card is current, and the exchange crosses cards."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(per_card * _cards())
    assert torch.cuda.current_device() == 0
    _sharded_vs_single(dev, backend, mesh)


def test_launcher_defaults_to_one_slab_per_card(dev, capsys):
    import argparse

    from repro_torch.launch import lbm as launcher

    cards = _cards()
    out = launcher.run_local(argparse.Namespace(
        case="duct", scale=1, order="zmajor", node_order="canonical",
        steps=3, tau=0.6, collision="lbgk", fluid="incompressible",
        dtype="float64", backend="fused", split_stream=False, device="cuda",
        slabs=None))
    assert out["slabs"] == out["devices"] == cards
    assert out["launches"]["stream_collide_tiles"] == 3 * cards
    assert np.isfinite(out["mass"]) and "halo:" in capsys.readouterr().out


def _ring_runs():
    """(geometry, config) of the NCCL exchange test: fused on a periodic-z
    ring (two messages each way between the two ranks of a ring of two),
    and gather + K2 in the paper layout with open boundaries."""
    from repro_torch.launch.lbm import _Z_FLOW

    g = random_spheres(box=32, porosity=0.6, diameter=8, seed=1)
    return [(g, LBMConfig(backend="fused", dtype="float64",
                          periodic=(True, True, True), u0=(0.01, 0.0, 0.02))),
            (duct_wrap(g), LBMConfig(dtype="float64", boundaries=_Z_FLOW,
                                     use_kernel=True, layout_scheme="paper"))]


NCCL_PROG = r"""
import sys
import numpy as np, torch, torch.distributed as dist
rank, world, addr, tests, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4], sys.argv[5])
sys.path.insert(0, tests)
from test_torch_cuda import _ring_runs
from repro_torch.dist.lbm import DistributedExchange, ShardedLBM
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=addr, rank=rank, world_size=world)
for i, (g, cfg) in enumerate(_ring_runs()):
    eng = ShardedLBM(g, cfg, slabs=world,
                     devices=[torch.device("cuda", r) for r in range(world)],
                     exchange=DistributedExchange())
    assert eng.slab_ids == [rank] and eng.device == torch.device("cuda", rank)
    eng.step(3)
    eng.run(3)
    np.save(f"{out}/f{i}_{rank}.npy", eng.f[0].cpu().numpy())
    np.save(f"{out}/mass{i}_{rank}.npy", np.array(eng.total_mass()))
dist.destroy_process_group()
print("NCCL_OK")
"""


@pytest.mark.parametrize("world", [2, 4])
def test_nccl_exchange_equals_local(dev, tmp_path, world):
    """One slab per rank on its own card, NCCL between them, gives the
    in-process engine's slab states (all slabs on the first card) bit for
    bit."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.dist.lbm import ShardedLBM

    if _cards() < world:
        pytest.skip(f"needs {world} cards")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        addr = f"tcp://localhost:{sock.getsockname()[1]}"
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(tests.parent / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PROG, str(r), str(world),
                               addr, str(tests), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "NCCL_OK" in so, se[-3000:]
    for i, (g, cfg) in enumerate(_ring_runs()):
        eng = ShardedLBM(g, cfg, slabs=world, devices=dev)
        eng.step(3)
        eng.run(3)
        for d in range(world):
            assert np.array_equal(np.load(tmp_path / f"f{i}_{d}.npy"),
                                  eng.f[d].cpu().numpy()), (i, d)
            assert float(np.load(tmp_path / f"mass{i}_{d}.npy")) == \
                pytest.approx(eng.total_mass(), rel=1e-12)


def _qkv(dev, dtype, b, s, t, h, kvh, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(b, t, kvh, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(b, t, kvh, hd, generator=g, device=dev).to(dtype)
    return q, k, v


K3_SHAPES = [
    (2, 4, 2, 200, 200, None, True),    # ragged last q block and key tile
    (2, 4, 4, 64, 64, 30.0, True),
    (2, 6, 2, 70, 130, None, False),    # S != T
    (2, 3, 1, 1, 33, 20.0, True),
    (1, 24, 2, 2048, 2048, None, True),  # the serving path's shape
    (2, 4, 2, 129, 129, None, True),    # one row past a 128-row block
    (1, 4, 2, 1, 300, None, False),     # one query, ragged 128-key tiles
    (2, 4, 2, 300, 300, 30.0, True),
]
# (window, prefix_len) on the causal shapes: a window of one key (each row
# sees itself only), windows on and one past the 64- and 128-key tile
# edges, a prefix short of, across and past a 128-row block, and both
K3_MASKS = [(None, 0), (1, 0), (63, 0), (64, 0), (129, 0), (None, 127),
            (None, 257), (None, 4096), (100, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", k3.HEAD_DIMS)
@pytest.mark.parametrize("b,h,kvh,s,t,softcap,causal,window,prefix", [
    shape + mask for shape in K3_SHAPES
    for mask in (K3_MASKS if shape[-1] else [(None, 0)])])
def test_k3_matches_plain(dev, dtype, hd, b, h, kvh, s, t, softcap, causal,
                          window, prefix):
    q, k, v = _qkv(dev, dtype, b, s, t, h, kvh, hd)
    kw = dict(softcap=softcap, causal=causal, window=window, prefix_len=prefix)
    before = k3.flash_attention.launches
    got = k3.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert k3.flash_attention.launches == before + 1
    want = k3.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    bound = k3.error_bound(q, k, v, want, **kw)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_k3_rejects_what_it_cannot_take(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 8, 8, 4, 2, 16)
    with pytest.raises(TypeError):
        k3.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        k3.flash_attention(*_qkv(dev, torch.float32, 1, 8, 8, 4, 2, 24))
    with pytest.raises(ValueError):
        k3.flash_attention(*_qkv(dev, torch.float32, 1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError):
        k3.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        k3.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        k3.flash_attention(q, k.bfloat16(), v)


# K3's forward with and without its lse output: each kernel (the Hopper one
# at bf16 hd 64/80/128/256, mma.sync at bf16 hd 16, FMA at float32 and hd 8)
# x causal, window, prefix with softcap, non-causal
K3_LSE_KERNELS = [(torch.bfloat16, 64), (torch.bfloat16, 80), (torch.bfloat16, 128),
                  (torch.bfloat16, 256), (torch.bfloat16, 16), (torch.float32, 64),
                  (torch.float32, 8)]
K3_LSE_MASKS = [dict(), dict(window=40), dict(prefix_len=70, softcap=30.0), dict(causal=False)]


@pytest.mark.parametrize("dtype,hd", K3_LSE_KERNELS)
@pytest.mark.parametrize("kw", K3_LSE_MASKS)
def test_k3_lse_output(dev, dtype, hd, kw):
    """K3's output is bit for bit the same with and without ``return_lse``,
    and its lse lies within 1e-5 relative of the plain version's (1e-5
    absolute where |lse| < 1: a row's lse can lie near 0)."""
    q, k, v = _qkv(dev, dtype, 2, 200, 200, 4, 2, hd)
    plain = k3.flash_attention(q, k, v, **kw)
    out, lse = k3.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    _, want = k3.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 200)
    assert bool(((lse - want).abs() <= 1e-5 * want.abs().clamp_min(1.0)).all())


# K3's backward kernel: (b, h, kvh, s) x (window, prefix, softcap): G = 1, 2
# and 12 (starcoder2's), ragged lengths around the 64-row and 64-key tiles
# (and the Hopper kernels' 128-key and 128-query blocks), a window of one
# key and one across tiles, prefixes short of, across and past a tile, all
# three at once
K3_BWD_SHAPES = [(1, 2, 2, 64), (2, 4, 2, 200), (1, 24, 2, 129), (1, 4, 2, 1)]
K3_BWD_MASKS = [(None, 0, None), (1, 0, None), (70, 0, None), (None, 63, None),
                (None, 130, None), (None, 0, 30.0), (40, 100, 30.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", k3.BWD_HEAD_DIMS)
@pytest.mark.parametrize("b,h,kvh,s", K3_BWD_SHAPES)
@pytest.mark.parametrize("window,prefix,softcap", K3_BWD_MASKS)
def test_k3_bwd_matches_plain(dev, dtype, hd, b, h, kvh, s, window, prefix, softcap):
    q, k, v = _qkv(dev, dtype, b, s, s, h, kvh, hd)
    kw = dict(softcap=softcap, window=window, prefix_len=prefix)
    out, lse = k3.flash_attention(q, k, v, return_lse=True, **kw)
    dout = torch.randn(q.shape, device=dev).to(dtype)
    before = k3.flash_attention_bwd.launches
    got = k3.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert k3.flash_attention_bwd.launches == before + 1
    x64 = [x.double() for x in (q, k, v, out, dout)]
    want = k3.flash_attention_bwd_ref(*x64, **kw)
    bounds = k3.error_bound_bwd(q, k, v, out, dout, want, **kw)
    for g, w, bound, x in zip(got, want, bounds, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert bool(((g.double() - w).abs() <= bound).all())


def test_k3_bwd_through_autograd_and_rejections(dev):
    q, k, v = (x.requires_grad_() for x in _qkv(dev, torch.bfloat16, 2, 96, 96, 4, 2, 64))
    out = k3.FlashAttention.apply(q, k, v, None, None, True, None, 0)
    before = k3.flash_attention_bwd.launches
    out.float().square().sum().backward()
    assert k3.flash_attention_bwd.launches == before + 1
    _, lse = k3.flash_attention(q.detach(), k.detach(), v.detach(), return_lse=True)
    want = k3.flash_attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(),
                                  (2 * out.float()).bfloat16(), lse)
    for x, w in zip((q, k, v), want):
        assert torch.equal(x.grad, w)
    a, b_, c = _qkv(dev, torch.float32, 1, 8, 8, 4, 2, 16)
    lse = torch.zeros(1, 4, 8, device=dev)
    with pytest.raises(ValueError):       # non-causal
        k3.flash_attention_bwd(a, b_, c, a, a, lse, causal=False)
    with pytest.raises(ValueError):       # hd 8: no backward kernel takes it
        x = _qkv(dev, torch.float32, 1, 8, 8, 4, 2, 8)
        k3.flash_attention_bwd(*x, x[0], x[0], lse)
    with pytest.raises(TypeError):
        k3.flash_attention_bwd(a, b_, c, a, a.bfloat16(), lse)
    with pytest.raises(ValueError):       # lse of another shape
        k3.flash_attention_bwd(a, b_, c, a, a, lse[:, :2])


@pytest.mark.parametrize("arch", ["gemma2-2b", "paligemma-3b"])
def test_local_and_prefix_models_serve_the_cpu_tokens(dev, arch):
    """gemma2's smoke model (window 16, prompts past it, decode past the
    ring's wrap) and paligemma's (prefix 8), float32, served on the card
    with K3 give the CPU run's greedy tokens; K3 launches once per layer
    per prefill."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import CausalLM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 9, 30)]
    cpu_model = CausalLM(cfg, device="cpu", seed=0)
    # the same weights on the card (a CUDA generator draws other numbers)
    params = convert.lm_params_to_reference(cpu_model)
    out = {}
    for device in ("cpu", dev):
        model = (cpu_model if device == "cpu" else
                 convert.lm_params_from_reference(params, cfg, device=device))
        eng = ServeEngine(model, 2, 48)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=12))
        out[str(device)] = {r.rid: r.out_tokens for r in eng.run()}
        launches = eng.k3_launches
    assert out["cpu"] == out["cuda"]
    assert launches == {"prefill": len(prompts) * cfg.n_layers, "decode": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,window,prefix,softcap", [
    (1, 1, 32, 32, None, 0, None), (1, 63, 32, 32, None, 0, None),
    (1, 64, 32, 32, None, 0, None), (1, 65, 32, 32, 64, 0, None),
    (1, 127, 4, 2, None, 127, None), (2, 128, 4, 2, None, 0, 50.0),
    (1, 129, 32, 32, 1, 0, None), (2, 200, 4, 2, 63, 0, None),
    (2, 255, 4, 2, None, 1, None), (1, 257, 4, 2, None, 300, 50.0),
    (1, 1000, 4, 2, 63, 0, 50.0), (1, 2048, 4, 2, 1000, 0, None),
    (2, 2048, 32, 32, None, 0, None)])
def test_k3_hd80_block_edges(dev, dtype, b, s, h, kvh, window, prefix, softcap):
    """hd 80 (zamba2's shared block): the Hopper kernel with its
    16-column tail chunk in bf16, the FMA kernel in float32, at lengths one
    short of, on and past the 128-row blocks and 128-key tiles (and the FMA
    kernel's 64), zamba2's head counts (H = KVH) up to its prompt length,
    GQA, two batches, windows, prefixes and softcap 50, causal and not."""
    for causal in (True, False):
        kw = dict(causal=causal, window=window if causal else None,
                  prefix_len=prefix if causal else 0, softcap=softcap)
        q, k, v = _qkv(dev, dtype, b, s, s, h, kvh, 80, seed=s)
        got = k3.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = k3.flash_attention_ref(q, k, v, **kw)
        bound = k3.error_bound(q, k, v, want, **kw)
        assert bool(((got.float() - want.float()).abs() <= bound).all())


def _card_copy(cfg, cpu_model, dev):
    """The CPU model's weights on the card (a CUDA generator draws other
    numbers than the CPU's)."""
    from repro_torch import convert

    return convert.lm_params_from_reference(convert.lm_params_to_reference(cpu_model),
                                            cfg, device=dev)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-2.7b", "rwkv6-3b"])
def test_moe_ssm_hybrid_models_serve_the_cpu_tokens(dev, arch):
    """The smoke models, float32, served on the card (K3 for deepseek's
    layers and zamba2's shared block) give the CPU run's greedy tokens and
    prefill logits within 1e-4 (the card's float32 products sum in another
    order); K3 launches once per attention layer per prefill."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.model import CausalLM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 64, 30)]
    cpu_model = CausalLM(cfg, device="cpu", seed=0)
    card_model = _card_copy(cfg, cpu_model, dev)
    toks = torch.as_tensor(prompts[1])[None]
    want, _ = cpu_model.prefill(toks, 96, torch.float32)
    got, _ = card_model.prefill(toks.to(dev), 96, torch.float32)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    out = {}
    for device, model in (("cpu", cpu_model), ("cuda", card_model)):
        eng = ServeEngine(model, 2, 96)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=10))
        out[device] = {r.rid: r.out_tokens for r in eng.run()}
        launches = eng.k3_launches
    assert out["cpu"] == out["cuda"]
    per_prefill = {"moe": cfg.n_layers, "hybrid": cfg.n_layers // cfg.attn_every,
                   "ssm": 0}[cfg.family]
    assert launches == {"prefill": len(prompts) * per_prefill, "decode": 0}


def test_moe_prefills_are_bit_identical(dev):
    """The MoE combine sums each token's k expert outputs in a fixed order
    (no atomics): two identical bf16 prefills on the card agree bit for
    bit, logits and cache."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import CausalLM

    model = CausalLM(get_smoke("deepseek-moe-16b"), device=dev, seed=0)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (2, 200)),
                           device=dev)
    (a, ca), (b, cb) = (model.prefill(toks, 256) for _ in range(2))
    assert torch.equal(a, b)
    for group in ca:
        for name in ca[group]:
            assert torch.equal(ca[group][name], cb[group][name])


# ------------------------------------------------------- the LM across cards
def _ep_width_rank(dev, comm, ranks, data, model):
    """moe_ffn_ep at deepseek-moe-16b's layer width (bf16, 1024 tokens a
    rank, the config's capacity factor 1.25) over ``ranks`` of a ``data``
    x ``model`` mesh, each rank with its own weight leaves: per rank its
    output, aux and gradients of sum(out * w) + rank 0's aux."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = get_config("deepseek-moe-16b")
    e_loc = cfg.moe.n_experts // model
    g = torch.Generator(device=dev).manual_seed(3)
    mod = M.MoE(cfg.d_model, cfg.d_ff, cfg.moe, cfg.mlp, device=dev)
    mod.reset_parameters(g)
    full = {**mod.weights(torch.float32), **mod.experts.weights(torch.float32)}
    xs = torch.randn(data * model, 1, 1024, cfg.d_model, generator=g, device=dev)
    ws = torch.randn(xs.shape, generator=g, device=dev)
    ps, leaves = [], []
    for r in ranks:
        own = {k: v.detach().to(torch.bfloat16 if k != "router" else v.dtype)
               .clone().requires_grad_() for k, v in full.items()}
        own["x"] = xs[r].to(torch.bfloat16).requires_grad_()
        lo = r % model * e_loc
        p = {k: own[k] for k in own if k not in ("up", "gate", "down", "x")}
        p.update({k: own[k][lo:lo + e_loc] for k in ("up", "gate", "down")})
        ps.append(p)
        leaves.append(own)
    outs, auxs = M.moe_ffn_ep(ps, [own["x"] for own in leaves], cfg.moe, cfg.mlp, comm)
    obj = 0.0
    for r, o, a in zip(ranks, outs, auxs):
        obj = obj + (o.float() * ws[r]).sum() + (a if r == 0 else 0.0 * a)
    obj.backward()
    return [{"out": o.detach(), "aux": a.detach(),
             **{k: v.grad for k, v in own.items()}} for o, a, own in zip(outs, auxs, leaves)]


EP_PROG = r"""
import sys, datetime
import torch, torch.distributed as dist
rank, world, addr, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, "tests")
from test_torch_cuda import _ep_width_rank
from repro_torch.dist.comm import DistComm
from repro_torch.launch.mesh import make_lm_mesh
dist.init_process_group("nccl", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
mesh = make_lm_mesh(2, world // 2)
comm = DistComm(mesh.get_group("model"))
res = _ep_width_rank(torch.device("cuda", rank), comm, [rank], 2, world // 2)[0]
torch.save({k: v.cpu() for k, v in res.items()}, f"{out}/rank{rank}.pt")
dist.destroy_process_group()
print("RANK_OK")
"""


def test_nccl_ep_equals_local_comm_at_deepseek_width(dev, tmp_path):
    """moe_ffn_ep over NCCL, a 2 x 2 mesh on four cards, gives LocalComm's
    per-rank outputs, aux and gradients (all four ranks on the first card)
    bit for bit."""
    from repro_torch.dist.comm import LocalComm

    if _cards() < 4:
        pytest.skip("needs 4 cards")
    from _ranks import run_ranks

    run_ranks(EP_PROG, 4, tmp_path, timeout=600)
    local = _ep_width_rank(dev, LocalComm(2, 2), range(4), 2, 2)
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for key, want in local[r].items():
            assert torch.equal(got[key], want.cpu()), (r, key)


STEP_PROG = r"""
import sys, datetime
import numpy as np, torch, torch.distributed as dist
rank, world, addr, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, "tests")
from test_torch_cuda import _smoke_step
from repro_torch.launch.mesh import make_lm_mesh
dist.init_process_group("nccl", init_method=addr, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))
res = _smoke_step(make_lm_mesh(2, 2))
if rank == 0:
    torch.save(res, f"{out}/ranks.pt")
dist.destroy_process_group()
print("RANK_OK")
"""


def _smoke_step(mesh=None):
    """One train step of deepseek's smoke (float32, capacity factor 8: no
    pair dropped) on 4 x 32 tokens from seed 0: metrics and the parameters
    after it, whole (across ranks: gathered, on rank 0)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.data.tokens import DataConfig, TokenPipeline
    from repro_torch.dist.zero import ranked_lm
    from repro_torch.models.model import CausalLM
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_smoke("deepseek-moe-16b")
    cfg = dataclasses.replace(base, dtype="float32",
                              moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    model = CausalLM(cfg, device="cuda", seed=0) if mesh is None else ranked_lm(cfg, mesh)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    place = model.placement             # the batch goes over "data"
    row, rows = (0, 1) if place is None else (place.data_rank, place.data)
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                          shard=row, num_shards=rows).next()
    _, m = step(init_state(dict(model.named_parameters())), batch, 0)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": lm_params_to_reference(model)}


def test_nccl_smoke_step_on_2x2_matches_one_card(dev, tmp_path):
    """A 2 x 2 mesh on four cards (the batch and ZeRO-3 over 2; tensor,
    sequence and expert parallelism over 2) takes the one-card step:
    metrics within 1e-5 relative, parameters after the step within 1e-5
    absolute (values of order 0.02)."""
    if _cards() < 4:
        pytest.skip("needs 4 cards")
    from _ranks import run_ranks

    run_ranks(STEP_PROG, 4, tmp_path, timeout=600)
    got = torch.load(tmp_path / "ranks.pt", weights_only=False)
    want = _smoke_step()
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value, rel=1e-5), key

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=path)

    walk(got["params"], want["params"])


def test_train_launcher_refuses_more_ranks_than_cards(dev):
    from repro_torch.launch import train

    cards = _cards()
    with pytest.raises(ValueError, match="cards"):
        train.main(["--arch", "deepseek-moe-16b", "--smoke", "--data", "1", "--model",
                    str(cards + 1), "--batch", str(cards + 1), "--steps", "1"])
