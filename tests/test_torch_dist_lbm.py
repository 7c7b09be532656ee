"""The slab-sharded engine: the port's ``repro_torch.dist.lbm`` against the
JAX package's ``repro.dist.lbm`` (float64, on the CPU, plain kernel
versions), against the port's own single engine, and its
``torch.distributed`` exchange against the in-process one.

The JAX ``ShardedLBM`` needs one XLA device per slab, so it runs in ONE
subprocess with ``--xla_force_host_platform_device_count=8`` set there only
(never in this process), under its own timeout, and writes npz files.  It
steps the JAX gather sharded engine: its fused sharded engine interprets
its kernel on the CPU (~24 s per tile order), and
``tests/test_multidevice.py::test_sharded_fused_backend_matches_gather``
holds it to the gather one to 1e-12.  The JAX fused engine is built, never
stepped, for its ``model_metrics``.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import collision as RC
from repro.core.boundary import BoundarySpec as RSpec
from repro.core.engine import LBMConfig as RConfig
from repro.core.tiling import INLET, OUTLET, SOLID
from repro.data import geometry as r_geo
from repro.dist import lbm as rdist
from repro.sim.registry import config_to_dict
from repro_torch import convert
from repro_torch.core.engine import SparseTiledLBM
from repro_torch.dist import lbm as pdist
from repro_torch.kernels.collide import collide_tiles
from repro_torch.kernels.stream_collide import stream_collide_tiles
from repro_torch.launch import lbm as launcher

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12
MASS_TOL = 1e-10
BCS = ((INLET, RSpec("velocity", (0, 0, 1), velocity=(0, 0, 0.05))),
       (OUTLET, RSpec("pressure", (0, 0, -1), rho=1.0)))
LBGK = RC.CollisionConfig(model="lbgk", fluid="incompressible", tau=0.8)


def _duct():
    return r_geo.duct(16, 16, 64, open_ends=True)


def _small_duct():
    return r_geo.duct(12, 12, 32, open_ends=True)


def _spheres():
    return r_geo.random_spheres(box=32, porosity=0.7, diameter=8, seed=1)


# name -> (geometry, reference config, slabs, schedule, port overrides):
# the reference steps its gather engine; the port runs each override on
# the same geometry and is held to it
CASES = {
    # tests/progs/sharded_lbm.py's case, and its split-stream variant
    "gather_paper": (_duct, RConfig(collision=LBGK, layout_scheme="paper",
                                    dtype="float64", boundaries=BCS),
                     8, [("step", 15)],
                     [{"use_kernel": True},
                      {"backend": "fused", "layout_scheme": "xyz"}]),
    "gather_split": (_duct, RConfig(collision=LBGK, layout_scheme="paper",
                                    dtype="float64", boundaries=BCS,
                                    split_stream=True,
                                    node_order="frontier_last"),
                     8, [("step", 15)], [{}]),
    # tests/progs/fused_slab.py's case, both slab-compatible tile orders
    "fused_zmajor": (_small_duct, RConfig(collision=LBGK, dtype="float64",
                                          boundaries=BCS),
                     8, [("step", 8), ("run", 4)], [{"backend": "fused"}]),
    "fused_morton_slab": (_small_duct, RConfig(
        collision=LBGK, dtype="float64", boundaries=BCS,
        tile_order="morton_slab"),
        8, [("step", 8), ("run", 4)], [{"backend": "fused"}]),
    # periodic z through the wrapped halo, MRT, quasi-compressible
    "periodic_mrt": (_spheres, RConfig(
        collision=RC.CollisionConfig(model="lbmrt",
                                     fluid="quasi_compressible", tau=0.7),
        dtype="float64", periodic=(True, True, True), u0=(0.01, 0.0, 0.02)),
        4, [("step", 15)], [{}, {"backend": "fused"}]),
}

# the JAX side: plan tables of every plan case, and each CASES entry's
# owned fields, mass and model_metrics (of its gather engine and of every
# port override's backend)
REF_PROG = r"""
import json, sys, warnings
import jax
jax.config.update("jax_enable_x64", True)
# the XLA CPU client runs the 8 host devices' parts of a step on a pool of
# as many threads as there are cores; a step's halo permute waits for all 8,
# so a pool thread taken by a transfer or the next step's part leaves one
# device never arriving.  Dispatch synchronously and wait for every step.
jax.config.update("jax_cpu_enable_async_dispatch", False)
import numpy as np
from jax.sharding import Mesh
from repro.dist.lbm import ShardedLBM
from repro.sim.registry import config_from_dict

warnings.simplefilter("ignore", RuntimeWarning)     # interpret-mode notice
out = sys.argv[1]
spec = json.load(open(f"{out}/spec.json"))
geoms = np.load(f"{out}/geoms.npz")

def mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("data",))

lists = {}
for key, (geom, cfg, d) in spec["plans"].items():
    try:
        eng = ShardedLBM(geoms[geom], config_from_dict(cfg), mesh(d),
                         dryrun=True)
    except AssertionError:
        lists[f"{key}/raises"] = np.ones(1)
        continue
    for k in ("su", "sd", "ru", "rum", "rd", "rdm"):
        if k in eng._tbl_np:
            lists[f"{key}/{k}"] = eng._tbl_np[k]
    lists[f"{key}/halo_bytes"] = np.array(eng.halo_bytes_per_step())
np.savez(f"{out}/plan_lists.npz", **lists)

metrics = {}
for name, c in spec["cases"].items():
    cfg = config_from_dict(c["cfg"])
    eng = ShardedLBM(geoms[c["geom"]], cfg, mesh(c["slabs"]))
    jax.block_until_ready((eng.f, eng._tbl))
    for how, n in c["schedule"]:
        for _ in range(n if how == "step" else 1):     # one step per step()
            getattr(eng, how)(1 if how == "step" else n)
            jax.block_until_ready(eng.f)
    rho, u, types, own = eng.macroscopics_own()
    np.savez(f"{out}/{name}.npz", rho=rho, u=u, types=types, own=own,
             mass=np.array(eng.total_mass()))
    metrics[name] = {}
    for i, ov in enumerate(c["overrides"]):
        m_cfg = config_from_dict(dict(c["cfg"], **ov))
        metrics[name][i] = ShardedLBM(geoms[c["geom"]], m_cfg,
                                      mesh(c["slabs"]),
                                      dryrun=True).model_metrics()
json.dump(metrics, open(f"{out}/metrics.json", "w"))
print("REF_OK")
"""

PLAN_GEOMS = {"duct": _duct, "spheres": _spheres}
PLAN_CASES = [(geom, order, pz, d) for geom in PLAN_GEOMS
              for order in ("zmajor", "morton_slab")
              for pz in (False, True) for d in (1, 2, 4, 8)]


def _plan_key(geom, order, pz, d):
    return f"{geom}-{order}-{int(pz)}-{d}"


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Run the JAX side once for the module; returns its output dir."""
    out = tmp_path_factory.mktemp("dist_ref")
    geoms = {name: make() for name, make in
             {**PLAN_GEOMS, "small_duct": _small_duct}.items()}
    np.savez(out / "geoms.npz", **geoms)
    geom_name = {_duct: "duct", _small_duct: "small_duct", _spheres: "spheres"}
    spec = {
        "plans": {_plan_key(g, o, pz, d): (g, config_to_dict(RConfig(
            tile_order=o, periodic=(False, False, pz), dtype="float64")), d)
            for g, o, pz, d in PLAN_CASES if d > 1},
        "cases": {name: {"geom": geom_name[make], "cfg": config_to_dict(cfg),
                         "slabs": d, "schedule": sched, "overrides": ovs}
                  for name, (make, cfg, d, sched, ovs) in CASES.items()},
    }
    (out / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REF_PROG, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "REF_OK" in proc.stdout, \
        proc.stdout + proc.stderr[-3000:]
    return out


# ----------------------------------------------------------------- plan
@pytest.mark.parametrize("geom,order,pz,d", PLAN_CASES,
                         ids=[_plan_key(*c) for c in PLAN_CASES])
def test_slab_plan_matches_reference(reference, geom, order, pz, d):
    """Byte-equal plans: layers, local tilings, owned masks, padding, the
    packed halo send/receive lists and the reference's halo byte count."""
    g = PLAN_GEOMS[geom]()
    lists = np.load(reference / "plan_lists.npz")
    key = _plan_key(geom, order, pz, d)
    if f"{key}/raises" in lists:             # periodic z, < 2 layers a slab
        for make in (rdist.make_slab_plan, pdist.make_slab_plan):
            with pytest.raises(AssertionError, match="periodic z"):
                make(g, 4, d, periodic_z=pz, tile_order=order)
        return
    want = rdist.make_slab_plan(g, 4, d, periodic_z=pz, tile_order=order)
    got = pdist.make_slab_plan(g, 4, d, periodic_z=pz, tile_order=order)
    for f in ("n_dev", "a", "tile_layers", "layer_of_dev", "own_z0", "t_max",
              "t_pad", "n_fluid_own", "periodic_z", "tile_order",
              "node_order", "tile_utilisation"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.own.dtype == want.own.dtype
    assert np.array_equal(got.own, want.own)
    assert len(got.local_tilings) == d
    for lg, lw in zip(got.local_tilings, want.local_tilings):
        for f in ("tile_coords", "node_types", "tile_map", "tile_neighbors"):
            a, b = getattr(lg, f), getattr(lw, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (lg.shape, lg.orig_shape, lg.tile_grid) == \
            (lw.shape, lw.orig_shape, lw.tile_grid)
    for dd in range(d):
        assert got.halo_layers_local(dd) == want.halo_layers_local(dd)
    hops, tables = pdist.halo_lists(got)
    if d == 1:
        assert hops == [] and tables == {}
        return
    for k in ("su", "sd", "ru", "rum", "rd", "rdm"):
        assert tables[k].dtype == lists[f"{key}/{k}"].dtype
        assert np.array_equal(tables[k], lists[f"{key}/{k}"]), k
    # every hop is one masked row of the reference's receive tables
    for h in hops:
        r, m = ((tables["ru"], tables["rum"]) if h.direction == pdist.UP
                else (tables["rd"], tables["rdm"]))
        assert np.array_equal(h.recv, r[h.dst][m[h.dst]])
        s = tables["su"] if h.direction == pdist.UP else tables["sd"]
        assert np.array_equal(h.send, s[h.src][:len(h.send)])


def test_slab_plan_rejects_global_curves():
    g = r_geo.duct_wrap(_spheres(), wall=4)
    for order in ("morton", "hilbert"):
        with pytest.raises(ValueError) as want:
            rdist.make_slab_plan(g, 4, 2, tile_order=order)
        with pytest.raises(ValueError) as got:
            pdist.make_slab_plan(g, 4, 2, tile_order=order)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------- engine
def _port_engine(name, override, **kw):
    make, cfg, d, sched, _ = CASES[name]
    pcfg = convert.config_from_reference(dict(config_to_dict(cfg), **override))
    eng = pdist.ShardedLBM(make(), pcfg, slabs=d, devices="cpu", **kw)
    for how, n in sched:
        getattr(eng, how)(n)
    return eng


PORT_RUNS = [(name, i) for name, c in CASES.items() for i in range(len(c[4]))]


@pytest.mark.parametrize("name,i", PORT_RUNS,
                         ids=[f"{n}-{CASES[n][4][i]}" for n, i in PORT_RUNS])
def test_sharded_matches_reference(reference, name, i):
    """Owned rho and u within 1e-12 of the JAX ShardedLBM in float64, the
    mass within 1e-10 relative, model_metrics equal to 1e-12 relative."""
    stream_collide_tiles.launches = collide_tiles.launches = 0
    eng = _port_engine(name, CASES[name][4][i])
    ref = np.load(reference / f"{name}.npz")
    rho, u, types, own = eng.macroscopics_own()
    assert rho.shape == ref["rho"].shape and u.shape == ref["u"].shape
    assert np.array_equal(types, ref["types"]) and np.array_equal(own, ref["own"])
    fluid = own[:, :, None] & (types != SOLID)
    assert np.all(np.isfinite(rho[fluid]))
    assert np.abs(np.where(fluid, rho - ref["rho"], 0.0)).max() < TOL
    assert np.abs(np.where(fluid[None], u - ref["u"], 0.0)).max() < TOL
    mass = float(ref["mass"])
    assert abs(eng.total_mass() - mass) < MASS_TOL * abs(mass)
    want = json.loads((reference / "metrics.json").read_text())[name][str(i)]
    got = eng.model_metrics()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL * abs(v), k
    # the CPU engine ran the kernels' plain versions
    assert stream_collide_tiles.launches == collide_tiles.launches == 0


@pytest.mark.parametrize("backend", ["fused", "gather"])
@pytest.mark.parametrize("slabs", [2, 4])
def test_sharded_bitwise_equals_single_engine(backend, slabs):
    """Owned tiles bit for bit the port's SparseTiledLBM after 15 steps."""
    kw = {"use_kernel": True} if backend == "gather" \
        else {"backend": "fused", "layout_scheme": "xyz"}
    make, cfg = CASES["gather_paper"][:2]
    pcfg = convert.config_from_reference(dict(config_to_dict(cfg), **kw))
    single = SparseTiledLBM(make(), pcfg, device="cpu")
    eng = pdist.ShardedLBM(make(), pcfg, slabs=slabs, devices="cpu")
    single.run(15)
    eng.run(15)
    want = single.backend.canonical(single.f)
    for d, b, f in zip(eng.slab_ids, eng.backends, eng.f):
        rows, g_rows = eng.plan.owned_rows(d, single.tiling)
        got = b.canonical(f)[:, torch.as_tensor(rows)]
        assert torch.equal(got, want[:, torch.as_tensor(g_rows)]), d
    assert len(eng.hops) == 2 * (slabs - 1)
    assert abs(eng.total_mass() - single.total_mass()) < MASS_TOL * single.total_mass()


def test_sharded_keeps_reference_errors_and_placement(monkeypatch):
    g = _small_duct()
    with pytest.raises(ValueError, match="layout_scheme"):
        pdist.ShardedLBM(g, convert.config_from_reference(config_to_dict(
            RConfig(backend="fused", layout_scheme="paper"))), 2, "cpu")
    with pytest.raises(ValueError, match="split_stream"):
        pdist.ShardedLBM(g, convert.config_from_reference(config_to_dict(
            RConfig(backend="fused", split_stream=True))), 2, "cpu")
    eng = pdist.ShardedLBM(g, convert.config_from_reference(config_to_dict(
        RConfig(dtype="float64"))), devices=["cpu", "cpu", "cpu"])
    assert eng.plan.n_dev == 3 and eng.slab_ids == [0, 1, 2]
    assert all(f.device.type == "cpu" for f in eng.f)


# ------------------------------------------------------------------ gloo
GLOO_PROG = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import convert
from repro_torch.dist.lbm import DistributedExchange, ShardedLBM
rank, world, addr, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfgs = [convert.config_from_reference(c) for c in __import__("json").loads(sys.argv[5])]
geoms = np.load(f"{out}/geoms.npz")
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world)
torch.set_num_threads(1)
for i, cfg in enumerate(cfgs):
    eng = ShardedLBM(geoms[str(i)], cfg, slabs=world, devices="cpu",
                     exchange=DistributedExchange())
    assert eng.slab_ids == [rank]
    eng.step(3)
    eng.run(3)
    np.save(f"{out}/f{i}_{rank}.npy", eng.f[0].numpy())
    np.save(f"{out}/mass{i}_{rank}.npy", np.array(eng.total_mass()))
dist.destroy_process_group()
print("GLOO_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_exchange_equals_local(tmp_path):
    """Two gloo ranks, one slab each, give the in-process engine's slab
    states bit for bit: the fused engine on a periodic-z ring (two messages
    between the same two ranks each step) and the gather engine in the
    paper layout with open boundaries."""
    runs = [(_spheres(), RConfig(collision=LBGK, dtype="float64",
                                 backend="fused",
                                 periodic=(True, True, True),
                                 u0=(0.01, 0.0, 0.02))),
            (_duct(), RConfig(collision=LBGK, dtype="float64",
                              layout_scheme="paper", boundaries=BCS))]
    np.savez(tmp_path / "geoms.npz", **{str(i): g for i, (g, _) in enumerate(runs)})
    cfgs = json.dumps([config_to_dict(c) for _, c in runs])
    addr = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_PROG, str(r), "2",
                               addr, str(tmp_path), cfgs], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0 and "GLOO_OK" in so, se[-3000:]
    for i, (g, cfg) in enumerate(runs):
        eng = pdist.ShardedLBM(g, convert.config_from_reference(
            config_to_dict(cfg)), slabs=2, devices="cpu")
        eng.step(3)
        eng.run(3)
        for d in range(2):
            assert np.array_equal(np.load(tmp_path / f"f{i}_{d}.npy"),
                                  eng.f[d].numpy()), (i, d)
            assert float(np.load(tmp_path / f"mass{i}_{d}.npy")) == \
                pytest.approx(eng.total_mass(), rel=MASS_TOL)


# -------------------------------------------------------------- launcher
def test_launcher_runs_sharded_and_prints_halo_bytes(capsys):
    out = launcher.run_local(argparse.Namespace(
        case="duct", scale=1, order="zmajor", node_order="canonical",
        steps=3, tau=0.6, collision="lbgk", fluid="incompressible",
        dtype="float32", backend="fused", split_stream=False, device="cpu",
        slabs=4))
    text = capsys.readouterr().out
    assert "devices=1 slabs=4" in text and "halo:" in text
    assert out["slabs"] == 4 and out["halo_bytes"] > 0
    assert out["halo_bytes_moved"] == out["halo_bytes"]   # uniform duct
    assert np.isfinite(out["mass"])


def test_launcher_cli_sharded_and_thin_case_fallback():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = [sys.executable, "-m", "repro_torch.launch.lbm", "--device", "cpu",
           "--slabs", "4", "--steps", "3"]
    proc = subprocess.run(run + ["--case", "duct"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "slabs=4" in proc.stdout and "B per step" in proc.stdout
    proc = subprocess.run(run + ["--case", "channel2d", "--backend", "gather"],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert ("case=channel2d: 1 z tile-layer(s) cannot feed 4 slabs; running "
            "single-device") in proc.stdout
    assert "slabs=1" in proc.stdout


def test_sharded_records_halo_metrics_and_span():
    """The reference's instrumentation: the step counter, the halo gauge
    and counter, and the ``lbm.run`` span marked sharded and naming the
    physics."""
    from repro_torch import obs

    reg, rec = obs.MetricRegistry(), obs.SpanRecorder()
    with obs.use(metrics=reg, trace=rec):
        eng = _port_engine("fused_zmajor", {"backend": "fused"})   # 8 + 4
    halo = eng.halo_bytes_per_step()
    assert halo > 0
    assert reg.value("lbm.step_total") == 12
    assert reg.value("dist.halo.bytes") == halo
    assert reg.value("dist.halo.bytes_total") == 12 * halo
    (span,) = rec.find("lbm.run")
    assert span.attrs == {"steps": 4, "sharded": True, "collision": "lbgk",
                          "fluid": "incompressible", "tau": 0.8}
