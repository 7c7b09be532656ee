"""The port's simulation-serving path (``repro_torch.sim``,
``repro_torch.checkpoint``) against the JAX package's, float64, on the CPU.

* gather ensembles: every replica bitwise equal to the port's own single
  engine (split and monolithic streaming, two tile/node orders);
* fused ensembles (one K1 step over B*T tiles, plain version here) within
  1e-12 of the JAX gather ensemble;
* building and seating an ensemble leaves the single engine's ping-pong
  state untouched;
* ``index_bytes_per_step`` equal to the reference's;
* ``SimService`` results within 1e-12 of the JAX ``SimService`` on the same
  submissions; checkpoints written by either package restored and finished
  by the other; the on-disk format byte-equal; torn checkpoints skipped.
"""
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as RStore
from repro.core import collision as RC
from repro.core.boundary import BoundarySpec as RSpec
from repro.core.engine import LBMConfig as RConfig
from repro.core.engine import SparseTiledLBM as REngine
from repro.core.tiling import INLET, OUTLET
from repro.data import geometry as r_geo
from repro.sim.registry import config_signature as r_signature
from repro.sim.registry import config_to_dict as r_config_to_dict
from repro.sim.service import SimService as RService
from repro_torch import convert
from repro_torch.checkpoint.store import COMMITTED, CheckpointStore
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.kernels.nebb_pass import replica_sources
from repro_torch.kernels.stream_collide import stream_collide_tiles
from repro_torch.sim.registry import (EngineRegistry, config_from_dict,
                                      config_signature, config_to_dict,
                                      geometry_fingerprint)
from repro_torch.sim.service import SimService, probe_indices

TOL = 1e-12
BCS = ((INLET, RSpec("velocity", (0, 0, 1), velocity=(0, 0, 0.03))),
       (OUTLET, RSpec("pressure", (0, 0, -1), rho=1.0)))
ORDERS = (("zmajor", "canonical"), ("morton", "frontier_last"))


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads; one thread keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spheres():
    return r_geo.duct_wrap(r_geo.random_spheres(box=12, porosity=0.6,
                                                diameter=6, seed=1), wall=2)


def _box(n=8):
    return np.ones((n, n, n), np.uint8)


def _channel():
    g = np.ones((8, 8, 8), np.uint8)
    g[:, 0, :] = 0
    g[:, -1, :] = 0
    return g


def _port(cfg) -> LBMConfig:
    return convert.config_from_reference(r_config_to_dict(cfg))


def _perturbed(feq: np.ndarray, b: int) -> np.ndarray:
    """Replica-distinct states, so parity is not vacuous."""
    return feq * (1.0 + 0.01 * (b + 1))


# ---------------------------------------------------------------- ensembles
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("tile_order,node_order", ORDERS)
def test_gather_ensemble_bitwise_equals_single_engine(batch, split, tile_order,
                                                      node_order):
    cfg = LBMConfig(layout_scheme="paper", dtype="float64", boundaries=BCS,
                    split_stream=split, tile_order=tile_order,
                    node_order=node_order)
    eng = SparseTiledLBM(_spheres(), cfg, device="cpu")
    ens = eng.ensemble(batch)
    feq = eng._initial_feq().numpy()
    singles = []
    for b in range(batch):
        single = SparseTiledLBM(_spheres(), cfg, device="cpu")
        single.f = single.backend.initial_state(torch.as_tensor(_perturbed(feq, b)))
        ens.set_replica(b, _perturbed(feq, b))
        singles.append(single)
    ens.step(4)
    for b, single in enumerate(singles):
        single.step(4)
        want = single.backend.canonical(single.f)
        assert torch.equal(ens.replica_canonical(b), want), f"replica {b}"
        assert ens.replica_mass(b) == pytest.approx(single.total_mass(), rel=1e-14)


@pytest.mark.parametrize("tile_order,node_order", ORDERS)
def test_fused_ensemble_matches_reference_gather_ensemble(tile_order, node_order):
    """One K1 step over 3 * T tiles plus the replicated NEBB pass, against
    the JAX gather ensemble from the same replica states."""
    ref_cfg = RConfig(dtype="float64", boundaries=BCS, tile_order=tile_order,
                      node_order=node_order,
                      collision=RC.CollisionConfig("lbmrt", "quasi_compressible", 0.7))
    ref = REngine(_spheres(), ref_cfg).ensemble(3)
    eng = SparseTiledLBM(_spheres(), convert.config_from_reference(
        dict(r_config_to_dict(ref_cfg), backend="fused")), device="cpu")
    ens = eng.ensemble(3)
    feq = np.asarray(ref.engine._initial_feq())
    for b in range(3):
        ref.set_replica(b, _perturbed(feq, b))
        ens.set_replica(b, _perturbed(feq, b))
    ref.step(4)
    stream_collide_tiles.launches = 0
    ens.run(4)
    assert stream_collide_tiles.launches == 0      # the plain version ran
    fluid = (eng.tiling.node_types != 0)[None]
    for b in range(3):
        got = ens.replica_canonical(b).numpy()
        want = np.asarray(ref.replica_canonical(b))
        assert np.abs(np.where(fluid, got - want, 0.0)).max() < TOL, b
    np.testing.assert_allclose(ens.total_mass(), np.asarray(ref.total_mass()),
                               rtol=TOL)
    rho, u = ens.macroscopics()
    rho_r, u_r = ref.macroscopics()
    assert np.abs(rho.numpy() - np.asarray(rho_r)).max() < TOL
    assert np.abs(u.numpy() - np.asarray(u_r)).max() < TOL


def test_fused_ensemble_periodic_matches_reference():
    """No NEBB pass: periodic wrap through the replicated neighbour table."""
    ref_cfg = RConfig(dtype="float64", periodic=(True, True, True),
                      collision=RC.CollisionConfig(model="lbmrt"),
                      u0=(0.01, 0.0, 0.02))
    g = r_geo.random_spheres(box=12, porosity=0.6, diameter=6, seed=2)
    ref = REngine(g, ref_cfg).ensemble(2)
    eng = SparseTiledLBM(g, convert.config_from_reference(
        dict(r_config_to_dict(ref_cfg), backend="fused")), device="cpu")
    ens = eng.ensemble(2)
    convert.ensemble_from_reference(np.asarray(ref.f), ens)   # gather layout
    ref.step(3)
    ens.step(3)
    packed = ens.f.numpy()                                    # fused layout
    assert packed.shape == (2 * eng.tiling.num_tiles + 1, 19, 64)
    again = eng.ensemble(2)
    convert.ensemble_from_reference(packed, again)
    assert torch.equal(again.f, ens.f)
    got = ens.canonical().numpy()
    want = np.asarray(ref.canonical())
    fluid = (ens.tiling.node_types != 0)[None, None]
    assert np.abs(np.where(fluid, got - want, 0.0)).max() < TOL


def test_ensemble_leaves_single_engine_untouched():
    """The fused engine's ping-pong pair survives building, seating, reset
    and stepping ensembles: the single engine goes on exactly as an engine
    that never saw one."""
    cfg = LBMConfig(backend="fused", dtype="float64", boundaries=BCS)
    eng = SparseTiledLBM(_spheres(), cfg, device="cpu")
    twin = SparseTiledLBM(_spheres(), cfg, device="cpu")
    eng.run(2)
    twin.run(2)
    bufs = tuple(t.data_ptr() for t in eng.backend._bufs)
    f_before = eng.f.clone()
    ens = eng.ensemble(3)
    ens.set_replica(1, _perturbed(eng._initial_feq().numpy(), 1))
    ens.run(2)
    ens.reset(0)
    ens.reset()
    assert tuple(t.data_ptr() for t in eng.backend._bufs) == bufs
    assert torch.equal(eng.f, f_before)
    for x in (ens.f, ens._spare):
        assert x.data_ptr() not in bufs and not x[-1].any()
    eng.run(3)
    twin.run(3)
    assert torch.equal(eng.f, twin.f)


def test_ensemble_rejects_gather_with_kernel():
    eng = SparseTiledLBM(_spheres(), LBMConfig(use_kernel=True), device="cpu")
    with pytest.raises(ValueError, match="use_kernel"):
        eng.ensemble(2)
    with pytest.raises(ValueError, match="batch"):
        SparseTiledLBM(_spheres(), LBMConfig(), device="cpu").ensemble(0)


@pytest.mark.parametrize("kw", [dict(layout_scheme="paper"),
                                dict(layout_scheme="paper", split_stream=True),
                                dict(backend="fused")])
def test_index_bytes_per_step_match_reference(kw):
    with warnings.catch_warnings():       # Pallas interpret-mode notice
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = REngine(_spheres(), RConfig(**kw))
    eng = SparseTiledLBM(_spheres(), _port(RConfig(**kw)), device="cpu")
    for batch in (1, 4):
        r, p = ref.ensemble(batch), eng.ensemble(batch)
        assert r.index_bytes_per_step() == p.index_bytes_per_step()
        assert r.index_bytes_per_node_update() == p.index_bytes_per_node_update()
        assert r.aggregate_mflups(1e-3) == p.aggregate_mflups(1e-3)


def test_ensemble_tables_offsets_in_int64():
    """A B-replicated state shares the engine's NEBB tables; the pass adds
    replica b's base b*T*Q*n in int64 (the offsets the tables were once
    copied with, per replica)."""
    eng = SparseTiledLBM(_spheres(), LBMConfig(backend="fused", boundaries=BCS),
                         device="cpu")
    types, nbrs, bc = eng.backend._ensemble_tables(3)
    t, q, n = eng.tiling.num_tiles, 19, 64
    assert bc is eng.backend._bc and bc.src.dtype == torch.int32
    assert nbrs.shape == (3 * t, 27) and int(nbrs.max()) == 3 * t
    assert types.shape == (3 * t + 1, n) and bool((types[-1] == 0).all())
    got = replica_sources(bc, 3, q, n)
    old = np.concatenate([bc.src.numpy().astype(np.int64)[:, None] + b * t * q * n
                          for b in range(3)], axis=1)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), old)
    assert bc.replicas(torch.empty(3 * t + 1, 1)) == 3
    with pytest.raises(ValueError, match="rows"):
        bc.replicas(torch.empty(3 * t, 1))


# ------------------------------------------------------------------ service
CFG = RConfig(layout_scheme="paper", dtype="float64",
              periodic=(True, True, True))
CFG_FORCE = RConfig(layout_scheme="paper", dtype="float64",
                    periodic=(True, False, True), force=(1e-5, 0.0, 0.0))
CFG_BC = RConfig(dtype="float64", boundaries=BCS, split_stream=True,
                 collision=RC.CollisionConfig("lbmrt", tau=0.7))
SUBMISSIONS = ((_box, CFG, 5, ((4, 4, 4),)), (_channel, CFG_FORCE, 8, ((4, 4, 4),)),
               (_box, CFG, 3, ()), (_spheres, CFG_BC, 6, ((6, 6, 6), (7, 8, 3))))


def _submit(svc, port: bool, **cfg_overrides):
    for geom, cfg, steps, probes in SUBMISSIONS:
        if port:
            cfg = convert.config_from_reference(
                dict(r_config_to_dict(cfg), **cfg_overrides))
        svc.submit(geom(), cfg, steps=steps, probes=probes)


def _assert_results_match(got: list, want: list):
    assert [s.sid for s in got] == [s.sid for s in want]
    for a, b in zip(got, want):
        ra, rb = a.result, b.result
        assert ra["steps"] == rb["steps"]
        for k in ("mass", "mass0"):
            assert ra[k] == pytest.approx(rb[k], rel=TOL, abs=0)
        for k in ("mass_drift", "mean_speed", "max_speed"):
            assert abs(ra[k] - rb[k]) < TOL, k
        assert len(ra.get("probes", ())) == len(rb.get("probes", ()))
        for pa, pb in zip(ra.get("probes", ()), rb.get("probes", ())):
            assert pa["point"] == pb["point"]
            assert abs(pa["rho"] - pb["rho"]) < TOL
            assert np.abs(np.subtract(pa["u"], pb["u"])).max() < TOL


def _sorted_finished(svc):
    return sorted(svc.finished, key=lambda s: s.sid)


@pytest.mark.parametrize("backend", ["gather", "fused"])
def test_service_matches_reference(backend):
    """4 sessions on 3 (geometry, config) groups, 2 slots: slot refill, probes,
    split streaming and open boundaries; fused groups run K1's plain version
    over 2 * T tiles."""
    ref = RService(slots=2)
    _submit(ref, port=False)
    ref.run()
    kw = {} if backend == "gather" else dict(backend="fused", layout_scheme="xyz",
                                             split_stream=False)
    svc = SimService(slots=2, device="cpu")
    _submit(svc, port=True, **kw)
    svc.run()
    _assert_results_match(_sorted_finished(svc), _sorted_finished(ref))
    assert svc.registry.stats()["compiled_engines"] == 3
    assert svc.registry.stats()["hits"] == 4


def _checkpoint_mid_run(svc, steps=3):
    svc.step(steps)
    return svc.checkpoint()


def test_reference_checkpoint_restored_by_port(tmp_path):
    """JAX serves, checkpoints mid-run and is killed; the port restores and
    finishes: the results equal JAX's uninterrupted run."""
    root = str(tmp_path / "ck")
    ref = RService(slots=2, checkpoint_root=root)
    _submit(ref, port=False)
    _checkpoint_mid_run(ref)
    del ref
    whole = RService(slots=2)
    _submit(whole, port=False)
    whole.run()
    svc = SimService.restore(root, slots=2, device="cpu")
    for sess in svc.queue:       # the port re-keys restored sessions itself
        assert sess.engine_key[1] == config_signature(sess.cfg)
    svc.run()
    _assert_results_match(_sorted_finished(svc), _sorted_finished(whole))


def test_port_checkpoint_restored_by_reference(tmp_path):
    root = str(tmp_path / "ck")
    svc = SimService(slots=2, checkpoint_root=root, device="cpu")
    _submit(svc, port=True)
    _checkpoint_mid_run(svc)
    del svc
    whole = SimService(slots=2, device="cpu")
    _submit(whole, port=True)
    whole.run()
    ref = RService.restore(root, slots=2)
    ref.run()
    _assert_results_match(_sorted_finished(whole), _sorted_finished(ref))


def test_checkpoint_format_equals_reference(tmp_path):
    """The same trees saved by both stores give the same manifest (bar the
    time), the same shard files' contents, and restore the same."""
    rng = np.random.default_rng(0)
    trees = {"s3": {"f": rng.normal(size=(19, 5, 64))},
             "geometries": {"b2": _channel(), "a1": _box()},
             "r1": {"u_dense": rng.normal(size=(3, 4, 4, 4)),
                    "rho_dense": rng.normal(size=(4, 4, 4)).astype(np.float32)}}
    extra = {"sessions": [{"sid": 3}], "next_sid": 4}
    pr = CheckpointStore(str(tmp_path / "p")).save(7, trees, extra)
    rr = RStore(str(tmp_path / "r")).save(7, trees, extra)
    man = []
    for d in (pr, rr):
        with open(os.path.join(d, "manifest.json")) as fh:
            m = json.load(fh)
        m.pop("time")
        man.append(m)
    assert man[0] == man[1]
    assert sorted(os.listdir(pr)) == sorted(os.listdir(rr))
    with np.load(os.path.join(pr, "shard_00000.npz")) as a, \
            np.load(os.path.join(rr, "shard_00000.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    store = CheckpointStore(str(tmp_path / "r"))
    assert store.latest() == 7 and store.verify(7)
    got, got_extra = store.restore_trees(7)
    assert got_extra == extra
    for tname, tree in trees.items():
        for k, v in tree.items():
            assert np.array_equal(got[tname][k], v) and got[tname][k].dtype == v.dtype


def test_checkpoint_tensors_and_async_save(tmp_path):
    """Torch leaves (copied at save time), save_async/wait, keep-newest gc,
    the ckpt.* counters."""
    from repro_torch import obs
    reg = obs.MetricRegistry()
    store = CheckpointStore(str(tmp_path), keep=2)
    f = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    with obs.use(metrics=reg):
        for step in range(3):
            store.save_async(step, {"s0": {"f": f}}, {"step": step})
            f += 1.0                            # after the snapshot
        store.wait()
        trees, extra = store.restore_trees(2)
    assert extra == {"step": 2}
    np.testing.assert_array_equal(trees["s0"]["f"], np.arange(12.0).reshape(3, 4) + 2)
    assert sorted(os.listdir(str(tmp_path))) == ["step_000000001", "step_000000002"]
    assert reg.value("ckpt.save_total") == 3
    assert reg.value("ckpt.save.bytes_total") == 3 * 12 * 8
    assert reg.value("ckpt.restore_total") == 1


def test_torn_checkpoint_falls_back(tmp_path):
    root = str(tmp_path / "ck")
    svc = SimService(slots=1, checkpoint_root=root, device="cpu")
    sid = svc.submit(_box(), _port(CFG), steps=6)
    svc.step(2)
    svc.checkpoint()                            # good save @ ckpt step 0
    svc.step(2)
    path = svc.checkpoint()                     # newer save @ ckpt step 1
    os.remove(os.path.join(path, COMMITTED))    # tear it
    svc2 = SimService.restore(root, slots=1, device="cpu")
    (sess, f) = svc2.live_sessions()[0]
    assert sess.sid == sid and sess.steps_done == 2
    finished = svc2.run()
    assert finished[0].result["steps"] == 6
    assert finished[0].result["mass_drift"] < 1e-12
    with pytest.raises(FileNotFoundError, match="torn"):
        CheckpointStore(root).restore_trees(1)
    with pytest.raises(FileNotFoundError):
        SimService.restore(str(tmp_path / "empty"), device="cpu")


def test_config_dicts_cross_packages():
    """The reference's dicts carry ``kernel_interpret``, which the port
    drops; the port's dicts load in the reference; signatures are each
    package's own."""
    ref_cfg = RConfig(collision=RC.CollisionConfig(model="lbmrt", tau=0.7),
                      boundaries=BCS[:1], force=(1e-5, 0.0, 0.0),
                      split_stream=True, tile_order="morton",
                      kernel_interpret=True)
    d = json.loads(json.dumps(r_config_to_dict(ref_cfg)))
    assert d["kernel_interpret"] is True
    cfg = config_from_dict(d)
    assert not hasattr(cfg, "kernel_interpret")
    assert config_from_dict(json.loads(json.dumps(config_to_dict(cfg)))) == cfg
    assert config_to_dict(cfg) == dict(r_config_to_dict(ref_cfg),
                                       kernel_interpret=None)
    from repro.sim.registry import config_from_dict as r_from_dict
    assert r_from_dict(json.loads(json.dumps(config_to_dict(cfg)))) \
        == RConfig(**{**ref_cfg.__dict__, "kernel_interpret": None})
    assert config_signature(cfg) != r_signature(ref_cfg)
    assert config_signature(cfg) == config_signature(config_from_dict(d))


# ------------------------------------------- service bookkeeping (port only)
def test_registry_shares_engine_not_state():
    reg = EngineRegistry(device="cpu")
    e1 = reg.get(_box(), _port(CFG))
    assert reg.get(_box().copy(), _port(CFG)) is e1 and e1.hits == 0
    assert geometry_fingerprint(_box()) != geometry_fingerprint(_channel())
    a = SimService(slots=1, registry=reg)
    b = SimService(slots=1, registry=reg)
    a.submit(_box(), _port(CFG), steps=50)
    b.submit(_box(), _port(CFG), steps=50)
    a.step(1)
    b.step(1)
    key = next(iter(a.groups))
    assert a.groups[key].ensemble is not b.groups[key].ensemble
    fb0 = b.groups[key].ensemble.replica_canonical(0).clone()
    a.step(3)
    assert torch.equal(b.groups[key].ensemble.replica_canonical(0), fb0)
    assert reg.compiled_count == 1


def test_service_budgets_refill_and_release():
    svc = SimService(slots=1, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        svc.submit(_box(), _port(CFG), steps=0)
    sids = [svc.submit(_box(), _port(CFG), steps=s) for s in (3, 2)]
    with pytest.warns(RuntimeWarning, match="unfinished"):
        svc.run(max_steps=2)
    assert svc.queue and svc.queue[0].sid == sids[1]
    finished = svc.run()
    assert [s.result["steps"] for s in finished] == [3, 2]
    assert svc.collect(sids[0])["sid"] == sids[0] and svc.collect(99) is None
    assert svc.release_idle() == 1 and not svc.groups
    assert svc.registry.compiled_count == 1


def test_service_reads_results_off_the_step_loop():
    """A finish leaves its reductions on the device; collect() reads every
    pending result at once, to the values run() gives."""
    def submit(svc):
        return [svc.submit(_box(), _port(CFG), steps=steps, probes=probes)
                for steps, probes in ((3, ((4, 4, 4), (5, 6, 7))), (2, ()))]

    whole = SimService(slots=1, device="cpu")
    submit(whole)
    whole.run()
    svc = SimService(slots=1, device="cpu")
    sids = submit(svc)
    while svc._step(1):
        pass
    assert [set(s.result) for s in svc.finished] == [{"sid", "steps"}] * 2
    assert all(torch.is_tensor(s.mass0) for s in svc.finished)
    assert [svc.collect(sid) for sid in sids] == [whole.collect(sid) for sid in sids]
    assert not svc._unread and all(s.pending is None for s in svc.finished)
    assert len(svc.collect(sids[0])["probes"]) == 2


def test_collect_fields_and_probe_validation():
    svc = SimService(slots=1, device="cpu")
    sid = svc.submit(_channel(), _port(CFG_FORCE), steps=4, collect_fields=True)
    svc.run()
    r = svc.collect(sid)
    assert r["rho_dense"].shape == (8, 8, 8) and r["u_dense"].shape == (3, 8, 8, 8)
    assert (r["rho_dense"][:, 0, :] == 1.0).all()
    assert np.nanmax(np.abs(r["u_dense"])) > 0
    tiling = svc.registry.get(_channel(), _port(CFG_FORCE)).engine.tiling
    with pytest.raises(ValueError, match="out of grid"):
        probe_indices(tiling, ((99, 0, 0),))
    g = _box()
    g[:4] = 0
    with pytest.raises(ValueError, match="empty"):
        svc.submit(g, _port(CFG), steps=1, probes=((0, 4, 4),))


def test_service_metrics_and_spans():
    from repro_torch import obs
    reg, rec = obs.MetricRegistry(), obs.SpanRecorder()
    with obs.use(metrics=reg, trace=rec):
        svc = SimService(slots=2, device="cpu")
        for steps in (2, 3, 1):
            svc.submit(_box(), _port(CFG), steps=steps, probes=((4, 4, 4),))
        svc.run()
    assert reg.value("sim.session.submitted_total") == 3
    assert reg.value("sim.session.finished_total") == 3
    assert reg.value("lbm.step_total") == 3          # one ensemble step each
    assert reg.value("sim.node_updates_total") == 6 * 512
    names = {s.name for s in rec.spans}
    assert {"sim.service.step", "sim.group.step", "lbm.ensemble.step"} <= names
    # the host's work for a session: a span each, under the right parent
    parent = {s.sid: s.name for s in rec.spans}
    for name, under in (("sim.service.submit", "-"),
                        ("sim.service.seat", "sim.service.step"),
                        ("sim.service.finish", "sim.service.step")):
        spans = rec.find(name)
        assert len(spans) == 3
        assert {parent.get(s.parent, "-") for s in spans} == {under}
    keys = [parent[k.parent] for k in rec.find("sim.registry.key")]
    assert all(k.attrs == {"bytes": 512} for k in rec.find("sim.registry.key"))
    # one in each submit, one at each session's first admission poll, and
    # one where the admission makes the group
    assert keys.count("sim.service.submit") == 3
    assert keys.count("sim.service.step") == 3 + 1
    (build,) = rec.find("sim.registry.build")
    assert parent[build.parent] == "sim.service.submit"
    (read,) = rec.find("sim.service.read_results")   # run() reads once
    assert read.parent == -1 and read.attrs == {"sessions": 3}
    # the drift gauges and finish events, recorded where the results arrive
    assert len(reg.values("lbm.mass.drift")) == 3
    assert max(reg.values("lbm.mass.drift").values()) < 1e-12
