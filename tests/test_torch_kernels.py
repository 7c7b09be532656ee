"""The port's collision and boundary functions and the plain versions of its
two kernels, held to the JAX package on the same inputs (float64).

* collision / NEBB boundary functions vs ``repro.core`` to 1e-13;
* ``collide_tiles_ref`` (K2's plain version) vs the Pallas collision kernel
  ``repro.kernels.ops.collide_tiles`` in interpret mode;
* ``stream_collide_tiles_ref`` (K1's plain version) vs the Pallas fused
  kernel ``repro.kernels.stream_collide.stream_collide_tiles`` in interpret
  mode, for the three kernel modes.

Inputs are made with numpy from a seed and handed to both sides.  The CPU
wrappers take the plain versions, so the kernels' launch counters stay 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as r_bnd
from repro.core import collision as r_col
from repro.core import lattice as r_lat
from repro.core import tiling as r_tiling
from repro.data import geometry as r_geo
from repro.kernels import ops as r_ops
from repro.kernels import stream_collide as r_sc
from repro_torch.core import boundary as p_bnd
from repro_torch.core import collision as p_col
from repro_torch.core import lattice as p_lat
from repro_torch.core import tiling as p_tiling
from repro_torch.kernels import collide as p_k2
from repro_torch.kernels import stream_collide as p_k1

TOL = 1e-13
VARIANTS = [(m, fl) for m in ("lbgk", "lbmrt")
            for fl in ("incompressible", "quasi_compressible")]


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _cfgs(model, fluid, tau=0.7):
    return (r_col.CollisionConfig(model=model, fluid=fluid, tau=tau),
            p_col.CollisionConfig(model=model, fluid=fluid, tau=tau))


def _f(rng, *shape):
    """Positive populations of order 0.1 (rho ~ 1 per node)."""
    return rng.uniform(0.02, 0.1, size=shape)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("force", [None, (1e-4, -2e-4, 3e-4)])
@pytest.mark.parametrize("model,fluid", VARIANTS)
def test_collision_functions_match(model, fluid, force):
    rng = np.random.default_rng(0)
    f = _f(rng, 19, 6, 5)
    lr, lp = r_lat.d3q19(), p_lat.d3q19()
    cr, cp = _cfgs(model, fluid)
    rho_r, u_r = r_col.macroscopics(jnp.asarray(f), lr, fluid)
    rho_p, u_p = p_col.macroscopics(torch.as_tensor(f), lp, fluid)
    assert _err(rho_r, rho_p) < TOL and _err(u_r, u_p) < TOL
    assert _err(r_col.equilibrium(rho_r, u_r, lr, fluid),
                p_col.equilibrium(rho_p, u_p, lp, fluid)) < TOL
    out_r, _, _ = r_col.collide(jnp.asarray(f), lr, cr, force)
    out_p, _, _ = p_col.collide(torch.as_tensor(f), lp, cp, force)
    assert _err(out_r, out_p) < TOL


def test_collision_d2q9_with_force_matches():
    rng = np.random.default_rng(1)
    f = _f(rng, 9, 4, 3)
    cr, cp = _cfgs("lbgk", "incompressible")
    out_r, _, _ = r_col.collide(jnp.asarray(f), r_lat.d2q9(), cr, (1e-5, 0, 0))
    out_p, _, _ = p_col.collide(torch.as_tensor(f), p_lat.d2q9(), cp, (1e-5, 0, 0))
    assert _err(out_r, out_p) < TOL


@pytest.mark.parametrize("kind,normal", [("velocity", (0, 0, 1)),
                                         ("velocity", (-1, 0, 0)),
                                         ("pressure", (0, 0, -1)),
                                         ("pressure", (0, 1, 0))])
def test_open_boundary_matches(kind, normal):
    rng = np.random.default_rng(2)
    f = _f(rng, 19, 5, 8)
    mask = rng.random((5, 8)) < 0.5
    kw = dict(velocity=(0.01, -0.02, 0.03), rho=1.02)
    out_r = r_bnd.apply_open_boundary(jnp.asarray(f), jnp.asarray(mask),
                                      r_bnd.BoundarySpec(kind, normal, **kw),
                                      r_lat.d3q19())
    out_p = p_bnd.apply_open_boundary(torch.as_tensor(f), torch.as_tensor(mask),
                                      p_bnd.BoundarySpec(kind, normal, **kw),
                                      p_lat.d3q19())
    assert _err(out_r, out_p) < TOL


@pytest.mark.parametrize("force", [None, (1e-4, 0.0, -2e-4)])
@pytest.mark.parametrize("model,fluid", VARIANTS)
def test_collide_tiles_ref_matches_pallas(model, fluid, force):
    rng = np.random.default_rng(3)
    t, n = 5, 64
    f = _f(rng, 19, t, n)
    solid = rng.random((t, n)) < 0.3
    f[:, solid] = 0.0
    cr, cp = _cfgs(model, fluid)
    out_r = r_ops.collide_tiles(jnp.asarray(f), jnp.asarray(solid),
                                r_lat.d3q19(), cr, force=force, interpret=True)
    p_k2.collide_tiles.launches = 0
    out_p = p_k2.collide_tiles(torch.as_tensor(f), torch.as_tensor(solid),
                               p_lat.d3q19(), cp, force=force)
    assert p_k2.collide_tiles.launches == 0          # CPU: plain version
    assert _err(out_r, out_p) < TOL
    assert not out_p[:, torch.as_tensor(solid)].any()


def _packed_inputs(rng, periodic):
    """Packed (T+1, Q, n) state, types and neighbours on an 8^3 box of
    spheres (8 tiles: the interpreted Pallas kernel costs seconds per
    tile), shared by both sides."""
    g = r_geo.random_spheres(box=8, porosity=0.6, diameter=4, seed=2)
    rt = r_tiling.tile_geometry(g, 4)
    pt = p_tiling.tile_geometry(g, 4)
    t = rt.num_tiles
    types = np.full((t + 1, 64), r_tiling.SOLID, np.uint8)
    types[:t] = rt.node_types
    f = np.zeros((t + 1, 19, 64))
    f[:t] = _f(rng, t, 19, 64)
    nbrs = r_sc.build_neighbor_table(rt, periodic)
    assert np.array_equal(nbrs, p_k1.build_neighbor_table(pt, periodic))
    return f, types, nbrs


# one interpreted fused kernel costs ~13 s here, so the full mode runs once,
# with the most involved collision (the math alone is covered above)
@pytest.mark.parametrize("mode,model,fluid,force,periodic", [
    ("full", "lbmrt", "quasi_compressible", (1e-4, 0.0, 2e-4), (False,) * 3),
    ("propagation_only", "lbgk", "incompressible", None, (True, False, True)),
    ("rw_only", "lbgk", "incompressible", None, (False,) * 3),
])
def test_stream_collide_tiles_ref_matches_pallas(mode, model, fluid, force,
                                                 periodic):
    rng = np.random.default_rng(4)
    f, types, nbrs = _packed_inputs(rng, periodic)
    cr, cp = _cfgs(model, fluid)
    out_r = r_sc.stream_collide_tiles(
        jnp.asarray(f), jnp.asarray(types), jnp.asarray(nbrs), r_lat.d3q19(),
        cr, a=4, force=force, interpret=True, mode=mode)
    p_k1.stream_collide_tiles.launches = 0
    out_p = p_k1.stream_collide_tiles(
        torch.as_tensor(f), torch.as_tensor(types), torch.as_tensor(nbrs),
        p_lat.d3q19(), cp, a=4, force=force, mode=mode)
    assert p_k1.stream_collide_tiles.launches == 0
    out_r = np.asarray(out_r)
    if mode == "full":                    # fluid slots: the reference's jnp
        fluid_slots = np.concatenate(     # math is unguarded at solid ones
            [types[:-1] != r_tiling.SOLID, np.zeros((1, 64), bool)])
        assert _err(out_r[fluid_slots[:, None, :].repeat(19, 1)],
                    out_p.numpy()[fluid_slots[:, None, :].repeat(19, 1)]) < TOL
    else:                                 # pure data movement: exact
        assert _err(out_r, out_p) == 0.0
    assert not out_p[-1].any()            # scratch row stays zero


def test_stream_collide_tiles_writes_into_out():
    """``out=`` receives the step; its scratch row is left zero."""
    rng = np.random.default_rng(5)
    f, types, nbrs = _packed_inputs(rng, (False,) * 3)
    args = (torch.as_tensor(types), torch.as_tensor(nbrs), p_lat.d3q19(),
            p_col.CollisionConfig())
    want = p_k1.stream_collide_tiles(torch.as_tensor(f), *args)
    out = torch.zeros_like(want)
    got = p_k1.stream_collide_tiles(torch.as_tensor(f), *args, out=out)
    assert got is out and torch.equal(out, want)
