"""Split-phase streaming and the dense oracle in the port, against the JAX
package and against the port's own monolithic engine.

* the split tables byte-equal to the reference's;
* the port's split engine bitwise equal to its monolithic engine in 'full'
  mode, over tile and node orders, and within 1e-12 of the JAX split
  engine in float64 (solid slots read zero under 'propagation_only', as in
  the reference);
* ``DenseLBM`` within 1e-12 of the JAX ``DenseLBM``;
* the three physics oracles of ``tests/test_physics.py`` replayed on the
  port: Poiseuille profile error < 2 %, mass drift < 1e-12 over the four
  collision x fluid variants, sparse == dense to 1e-12.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import collision as RC
from repro.core import lattice as r_lat
from repro.core import streaming as r_stream
from repro.core import tiling as r_tiling
from repro.core.boundary import BoundarySpec as RSpec
from repro.core.dense import DenseLBM as RDense
from repro.core.engine import LBMConfig as RConfig
from repro.core.engine import SparseTiledLBM as REngine
from repro.core.tiling import INLET, OUTLET
from repro.data import geometry as r_geo
from repro.sim.registry import config_to_dict
from repro_torch import convert
from repro_torch.core import collision as C
from repro_torch.core import lattice as p_lat
from repro_torch.core import streaming as p_stream
from repro_torch.core import tiling as p_tiling
from repro_torch.core.dense import DenseLBM
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.core.tiling import SOLID
from repro_torch.data.geometry import channel2d

TOL = 1e-12
BCS = ((INLET, RSpec("velocity", (0, 0, 1), velocity=(0, 0, 0.03))),
       (OUTLET, RSpec("pressure", (0, 0, -1), rho=1.0)))
ORDERS = [("zmajor", "canonical"), ("morton", "frontier_last"),
          ("hilbert", "sfc")]


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


def _spheres(box=16):
    return r_geo.random_spheres(box=box, porosity=0.6, diameter=8, seed=1)


def _walled():
    return r_geo.duct_wrap(_spheres(), wall=2)


def _port_cfg(ref_cfg, **overrides):
    return convert.config_from_reference(dict(config_to_dict(ref_cfg), **overrides))


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True),
                                      (True, False, True)])
@pytest.mark.parametrize("tile_order,node_order", ORDERS)
def test_split_tables_copy(tile_order, node_order, periodic):
    """Every split table, on geometries whose extents are not tile
    multiples (18 x 18 x 16 walled; periodic 18^3, where links that wrap
    land in the irregular list)."""
    g = _walled() if not any(periodic) else _spheres(18)
    rt = r_tiling.tile_geometry(g, 4, order=tile_order, node_order=node_order)
    pt = p_tiling.tile_geometry(g, 4, order=tile_order, node_order=node_order)
    for scheme in ("xyz", "paper"):
        r = r_stream.build_stream_tables(rt, r_lat.d3q19(), scheme, periodic,
                                         split=True).split
        p = p_stream.build_stream_tables(pt, p_lat.d3q19(), scheme, periodic,
                                         split=True).split
        for field in ("intra_idx", "case", "is_cross", "nbr", "bounce_dst",
                      "irregular_dst", "irregular_src", "opp"):
            a, b = getattr(r, field), getattr(p, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field
        assert r.index_bytes == p.index_bytes
    if periodic == (True, False, True):
        assert len(p.irregular_dst) > 0


def test_split_tables_need_every_tile():
    pt = p_tiling.tile_geometry(_walled(), 4)
    with pytest.raises(ValueError, match="every tile"):
        p_stream.build_stream_tables(pt, p_lat.d3q19(), split=True,
                                     tiles=np.arange(3))


# ------------------------------------------------------------ split engine
def _canonical(eng):
    return eng.backend.canonical(eng.f).numpy()


@pytest.mark.parametrize("tile_order,node_order", ORDERS)
@pytest.mark.parametrize("model", ["lbgk", "lbmrt"])
def test_split_engine_bitwise_equals_monolithic(tile_order, node_order, model):
    kw = dict(collision=C.CollisionConfig(model, C.QUASI_COMPRESSIBLE, 0.7),
              dtype="float64", layout_scheme="paper", boundaries=BCS,
              tile_order=tile_order, node_order=node_order)
    mono = SparseTiledLBM(_walled(), LBMConfig(**kw), device="cpu")
    split = SparseTiledLBM(_walled(), LBMConfig(split_stream=True, **kw),
                           device="cpu")
    mono.run(5)
    split.run(5)
    assert np.array_equal(_canonical(mono), _canonical(split), equal_nan=True)
    assert split.index_bytes_per_step() < mono.index_bytes_per_step() / 5


@pytest.mark.parametrize("periodic,geom", [
    ((False, False, False), "walled"), ((True, True, True), "spheres"),
    ((True, False, True), "odd")])
@pytest.mark.parametrize("tile_order,node_order", ORDERS[:2])
def test_split_engine_matches_reference(periodic, geom, tile_order, node_order):
    g = {"walled": _walled, "spheres": _spheres,
         "odd": lambda: _spheres(18)}[geom]()
    cfg = RConfig(dtype="float64", split_stream=True, layout_scheme="paper",
                  periodic=periodic, tile_order=tile_order,
                  node_order=node_order, u0=(0.01, 0.0, 0.02),
                  boundaries=BCS if geom == "walled" else (),
                  collision=RC.CollisionConfig(model="lbmrt", tau=0.8))
    ref = REngine(g, cfg)
    ref.run(6)
    eng = SparseTiledLBM(g, _port_cfg(cfg), device="cpu")
    eng.run(6)
    want = np.asarray(ref.backend.canonical(ref.f))
    fluid = (eng.tiling.node_types != SOLID)[None]
    assert np.abs(np.where(fluid, _canonical(eng) - want, 0.0)).max() < TOL
    assert ref.index_bytes_per_step() == eng.index_bytes_per_step()
    assert ref.model_metrics() == eng.model_metrics()


def test_split_propagation_only_matches_reference():
    """Under split streaming 'propagation_only' writes zero at solid slots
    (the monolithic path writes the bounce value there): bit for bit as
    the reference."""
    cfg = RConfig(dtype="float64", split_stream=True, boundaries=BCS,
                  kernel_mode="propagation_only", u0=(0.0, 0.0, 0.02))
    ref = REngine(_walled(), cfg)
    ref.run(3)
    eng = SparseTiledLBM(_walled(), _port_cfg(cfg), device="cpu")
    eng.run(3)
    got = _canonical(eng)
    assert np.array_equal(got, np.asarray(ref.backend.canonical(ref.f)))
    assert not got[:, eng.tiling.node_types == SOLID].any()


def test_split_needs_gather_backend():
    with pytest.raises(ValueError, match="split_stream"):
        SparseTiledLBM(_walled(), LBMConfig(split_stream=True, backend="fused"),
                       device="cpu")


# ------------------------------------------------------------------- dense
@pytest.mark.parametrize("case", ["periodic", "duct"])
def test_dense_matches_reference(case):
    if case == "periodic":
        rng = np.random.default_rng(3)
        g = (rng.random((12, 12, 12)) < 0.8).astype(np.uint8)
        kw = dict(periodic=(True, True, True), u0=(0.01, 0.0, 0.02),
                  collision=RC.CollisionConfig("lbmrt", "quasi_compressible", 0.65))
    else:
        g = r_geo.duct(10, 10, 24)
        kw = dict(boundaries=BCS, collision=RC.CollisionConfig(tau=0.8))
    cfg = RConfig(dtype="float64", **kw)
    ref = RDense(g, cfg)
    ref.step(8)
    eng = DenseLBM(g, _port_cfg(cfg), device="cpu")
    eng.step(8)
    fluid = (g != SOLID)[None]
    assert np.abs(np.where(fluid, eng.f.numpy() - np.asarray(ref.f), 0)).max() < TOL
    rho_r, u_r = ref.macroscopics()
    rho_p, u_p = eng.macroscopics()
    assert np.abs(rho_p.numpy() - np.asarray(rho_r)).max() < TOL
    assert np.abs(u_p.numpy() - np.asarray(u_r)).max() < TOL
    assert abs(eng.total_mass() - ref.total_mass()) < TOL * ref.total_mass()
    assert eng.n_fluid_nodes == ref.n_fluid_nodes


# ------------------------------------------- physics oracles on the port
def test_poiseuille_2d_analytic():
    """Body-force D2Q9 channel converges to u(y) = g/(2 nu) y (H - y)
    (half-way bounce-back walls), as ``test_physics.py`` checks."""
    ny, g_force, tau = 21, 1e-6, 0.8
    nu = (tau - 0.5) / 3.0
    cfg = LBMConfig(lattice="D2Q9", layout_scheme="xyz", dtype="float32",
                    collision=C.CollisionConfig(C.LBGK, C.INCOMPRESSIBLE, tau),
                    periodic=(True, False, True), force=(g_force, 0.0, 0.0))
    eng = SparseTiledLBM(channel2d(4, ny), cfg, device="cpu")
    eng.run(4000)
    _, u = eng.fields_dense()
    ux = u[0, 1, 1:ny - 1, 0]
    y = np.arange(1, ny - 1) - 0.5
    u_exact = g_force / (2 * nu) * y * (ny - 2.0 - y)
    err = np.abs(ux - u_exact).max() / u_exact.max()
    assert err < 0.02, f"Poiseuille profile error {err:.3%}"


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("model", ["lbgk", "lbmrt"])
@pytest.mark.parametrize("fluid", ["incompressible", "quasi_compressible"])
def test_mass_conservation_closed_box(model, fluid, split):
    cfg = LBMConfig(collision=C.CollisionConfig(model, fluid, 0.7),
                    layout_scheme="paper", dtype="float64", split_stream=split,
                    periodic=(True, True, True), u0=(0.02, 0.01, -0.015))
    eng = SparseTiledLBM(np.ones((8, 8, 8), np.uint8), cfg, device="cpu")
    m0 = eng.total_mass()
    eng.step(50)
    assert abs(eng.total_mass() - m0) / m0 < 1e-12


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("layout", ["xyz", "paper"])
def test_sparse_matches_dense_engine(layout, split):
    rng = np.random.default_rng(3)
    g = (rng.random((12, 12, 12)) < 0.8).astype(np.uint8)
    g[5:7, 5:7, 5:7] = 1
    cfg = LBMConfig(collision=C.CollisionConfig(tau=0.65), layout_scheme=layout,
                    dtype="float64", split_stream=split,
                    periodic=(True, True, True), u0=(0.01, 0.0, 0.02))
    sp = SparseTiledLBM(g, cfg, device="cpu")
    de = DenseLBM(np.pad(g, [(0, sp.tiling.shape[i] - g.shape[i])
                             for i in range(3)]), cfg, device="cpu")
    sp.step(10)
    de.step(10)
    rho_s, u_s = sp.fields_dense()
    rho_d, u_d = (x.numpy() for x in de.macroscopics())
    fluid = de.node_type != SOLID
    assert np.nanmax(np.abs(np.where(fluid, rho_s - rho_d, 0))) < 1e-12
    assert np.max(np.abs(np.where(fluid[None], u_s - u_d, 0))) < 1e-12
