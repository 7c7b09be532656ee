"""The whole slice: the port's SparseTiledLBM on the CPU (fused and gather,
with and without the collision kernel's plain version) against the JAX
package's gather engine, float64, 1e-12 at fluid slots after N steps; plus
``repro_torch.convert``.

The JAX fused engine only interprets on the CPU (seconds per step), so the
reference physics comes from its gather engine, which the JAX package's
own tests pin to its fused engine; a JAX fused engine is built (never
stepped) only for its ``model_metrics``.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

from repro.core import collision as RC
from repro.core.boundary import BoundarySpec as RSpec
from repro.core.engine import LBMConfig as RConfig
from repro.core.engine import SparseTiledLBM as REngine
from repro.core.tiling import INLET, OUTLET
from repro.data import geometry as r_geo
from repro.sim.registry import config_to_dict
from repro_torch import convert
from repro_torch.core.engine import SparseTiledLBM as PEngine
from repro_torch.kernels.collide import collide_tiles
from repro_torch.kernels.stream_collide import stream_collide_tiles

TOL = 1e-12

BCS = ((INLET, RSpec("velocity", (0, 0, 1), velocity=(0, 0, 0.03))),
       (OUTLET, RSpec("pressure", (0, 0, -1), rho=1.0)))


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _spheres():
    return r_geo.random_spheres(box=16, porosity=0.6, diameter=8, seed=1)


def _ref(g, steps, **kw):
    """JAX gather engine after ``steps``: canonical f, mass, config."""
    cfg = RConfig(dtype="float64", backend="gather", **kw)
    eng = REngine(g, cfg)
    eng.run(steps)
    return np.asarray(eng.backend.canonical(eng.f)), eng.total_mass(), cfg


def _port(g, ref_cfg, steps, **overrides):
    d = dict(config_to_dict(ref_cfg), **overrides)
    eng = PEngine(g, convert.config_from_reference(d), device="cpu")
    eng.run(steps)
    return eng


def _assert_parity(eng, f_ref, mass_ref):
    f = eng.backend.canonical(eng.f).numpy()
    fluid = (eng.tiling.node_types != 0)[None]
    assert np.all(np.isfinite(f))
    assert np.abs(np.where(fluid, f - f_ref, 0.0)).max() < TOL
    assert abs(eng.total_mass() - mass_ref) < TOL * abs(mass_ref)


def _assert_metrics(g, eng, ref_cfg):
    """model_metrics key for key against the JAX engine of the same
    backend and layout (built, not stepped)."""
    d = dataclasses.asdict(eng.cfg)
    d["collision"] = RC.CollisionConfig(**d["collision"])
    d["boundaries"] = ref_cfg.boundaries
    with warnings.catch_warnings():       # Pallas interpret-mode notice
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = REngine(g, RConfig(**d))
    assert ref.model_metrics() == eng.model_metrics()


def _check_all_backends(g, steps, **kw):
    f_ref, mass_ref, cfg = _ref(g, steps, **kw)
    stream_collide_tiles.launches = collide_tiles.launches = 0
    for overrides in ({}, {"use_kernel": True},
                      {"backend": "fused", "layout_scheme": "xyz"}):
        eng = _port(g, cfg, steps, **overrides)
        _assert_parity(eng, f_ref, mass_ref)
        _assert_metrics(g, eng, cfg)
    # the CPU engines ran the kernels' plain versions, never a kernel
    assert stream_collide_tiles.launches == collide_tiles.launches == 0


@pytest.mark.parametrize("model,fluid", [
    ("lbgk", "incompressible"), ("lbgk", "quasi_compressible"),
    ("lbmrt", "incompressible"), ("lbmrt", "quasi_compressible")])
def test_spheres_periodic_matches_reference(model, fluid):
    _check_all_backends(
        _spheres(), 6,
        collision=RC.CollisionConfig(model=model, fluid=fluid, tau=0.7),
        periodic=(True, True, True), u0=(0.01, 0.0, 0.02))


def test_duct_wrap_open_boundaries_match_reference():
    """Porous block in a solid duct, NEBB velocity inlet and pressure
    outlet, paper layout on the gather side."""
    g = r_geo.duct_wrap(_spheres(), wall=4)
    _check_all_backends(g, 8, collision=RC.CollisionConfig(tau=0.8),
                        boundaries=BCS, layout_scheme="paper")


def test_cavity_lid_matches_reference():
    bcs = ((r_geo.LID, RSpec("velocity", (0, 0, -1),
                             velocity=(0.05, 0.0, 0.0))),)
    _check_all_backends(r_geo.cavity3d(12), 8,
                        collision=RC.CollisionConfig(tau=0.6), boundaries=bcs)


def test_morton_frontier_last_with_force_matches_reference():
    _check_all_backends(
        _spheres(), 5, collision=RC.CollisionConfig(tau=0.7),
        periodic=(True, True, True), force=(1e-5, 0.0, 0.0),
        tile_order="morton", node_order="frontier_last")


def test_channel2d_d2q9_with_force_matches_reference():
    """D2Q9 body-force channel on the gather backend (periodic along a
    1-node z extent, which the fused tile wrap does not take)."""
    g = r_geo.channel2d(16, 12)
    f_ref, mass_ref, cfg = _ref(
        g, 10, lattice="D2Q9", collision=RC.CollisionConfig(tau=0.8),
        periodic=(True, False, True), force=(1e-5, 0.0, 0.0))
    for overrides in ({}, {"use_kernel": True}):
        eng = _port(g, cfg, 10, **overrides)
        _assert_parity(eng, f_ref, mass_ref)
        _assert_metrics(g, eng, cfg)


@pytest.mark.parametrize("mode", ["propagation_only", "rw_only"])
def test_kernel_mode_variants_match_reference(mode):
    g = _spheres()
    kw = dict(kernel_mode=mode, periodic=(True, True, True),
              u0=(0.01, 0.0, 0.02))
    cfg = RConfig(dtype="float64", **kw)
    ref = REngine(g, cfg)
    ref.run(4)
    want = np.asarray(ref.backend.canonical(ref.f))
    for overrides in ({}, {"backend": "fused"}):
        eng = _port(g, cfg, 4, **overrides)
        assert np.array_equal(eng.backend.canonical(eng.f).numpy(), want)


def test_reset_and_fields_dense_match_reference():
    g = _spheres()
    kw = dict(collision=RC.CollisionConfig(tau=0.7), periodic=(True,) * 3,
              u0=(0.01, 0.0, 0.02))
    ref = REngine(g, RConfig(dtype="float64", **kw))
    ref.run(3)
    eng = _port(g, RConfig(dtype="float64", **kw), 5, backend="fused")
    eng.reset()
    eng.run(3)
    for a, b in zip(ref.fields_dense(), eng.fields_dense()):
        assert np.allclose(a, b, rtol=0, atol=TOL, equal_nan=True)
    for a, b in zip(ref.macroscopics(), eng.macroscopics()):
        assert np.abs(np.asarray(a) - b.numpy()).max() < TOL


# ------------------------------------------------------------------ convert
def test_config_from_reference_round_trip():
    cfg = RConfig(collision=RC.CollisionConfig("lbmrt", "quasi_compressible",
                                               0.9),
                  boundaries=BCS, periodic=(True, False, True),
                  force=(1e-5, 0.0, 0.0), u0=(0.01, 0.0, 0.0),
                  tile_order="hilbert", node_order="sfc", dtype="float64",
                  backend="fused", kernel_mode="propagation_only")
    port = convert.config_from_reference(config_to_dict(cfg))
    want = config_to_dict(cfg)
    del want["kernel_interpret"]
    assert dataclasses.asdict(port) == want


def test_config_from_reference_rejects_split_stream():
    """split_stream carries over from the reference's dict; as in the
    reference, an engine rejects it on the fused backend only."""
    d = config_to_dict(RConfig(split_stream=True))
    assert convert.config_from_reference(d).split_stream
    fused = convert.config_from_reference(dict(d, backend="fused"))
    with pytest.raises(ValueError, match="split_stream"):
        PEngine(_spheres(), fused, device="cpu")


@pytest.mark.parametrize("layout", ["xyz", "paper"])
def test_port_continues_reference_mid_run(layout):
    """The JAX engine runs 4 steps; the port (gather and fused) takes its
    state and both run 4 more."""
    g = r_geo.duct_wrap(_spheres(), wall=4)
    cfg = RConfig(dtype="float64", collision=RC.CollisionConfig(tau=0.8),
                  boundaries=BCS, layout_scheme=layout)
    ref = REngine(g, cfg)
    ref.run(4)
    mid = np.asarray(ref.f)                        # (Q, T, n) storage layout
    ref.run(4)
    want = np.asarray(ref.backend.canonical(ref.f))
    backends = [{}] + ([{"backend": "fused"}] if layout == "xyz" else [])
    for overrides in backends:
        d = dict(config_to_dict(cfg), **overrides)
        eng = PEngine(g, convert.config_from_reference(d), device="cpu")
        eng.f = convert.state_from_reference(mid, eng)
        if not overrides:                          # same layout: round trip
            assert np.array_equal(convert.state_to_reference(eng), mid)
        eng.run(4)
        fluid = (eng.tiling.node_types != 0)[None]
        got = eng.backend.canonical(eng.f).numpy()
        assert np.abs(np.where(fluid, got - want, 0.0)).max() < TOL


def test_state_from_reference_packed_round_trip():
    """A JAX fused engine's packed state carries over exactly."""
    g = _spheres()
    cfg = RConfig(dtype="float64", backend="fused", periodic=(True,) * 3,
                  u0=(0.01, 0.0, 0.02))
    with pytest.warns(RuntimeWarning):
        ref = REngine(g, cfg)
    packed = np.asarray(ref.f)
    eng = PEngine(g, convert.config_from_reference(config_to_dict(cfg)),
                  device="cpu")
    eng.f = convert.state_from_reference(packed, eng)
    assert np.array_equal(convert.state_to_reference(eng), packed)
    with pytest.raises(ValueError, match="neither packed"):
        convert.state_from_reference(packed[:-2], eng)
