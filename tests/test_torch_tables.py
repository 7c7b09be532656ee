"""The port's host-side numpy tables are byte-equal to the JAX package's.

The port keeps its own copies of the tiler, the stream-table builder and
the fused kernel's static tables (it never imports the JAX package); these
tests hold every copy to the reference on the same geometries, under every
tile order x node order, periodic and not.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core import lattice as r_lat
from repro.core import streaming as r_stream
from repro.core import tiling as r_tiling
from repro.core.backends import boundary_pass_tables as r_boundary_tables
from repro.core.boundary import BoundarySpec as RSpec
from repro.data import geometry as r_geo
from repro.kernels import stream_collide as r_sc
from repro_torch.core import lattice as p_lat
from repro_torch.core import streaming as p_stream
from repro_torch.core import tiling as p_tiling
from repro_torch.core.backends import boundary_pass_tables as p_boundary_tables
from repro_torch.core.boundary import BoundarySpec as PSpec
from repro_torch.data import geometry as p_geo
from repro_torch.kernels import stream_collide as p_sc

ORDERS = [(to, no) for to in r_tiling.TILE_ORDERS for no in r_tiling.NODE_ORDERS]


def _spheres():
    g = r_geo.random_spheres(box=16, porosity=0.6, diameter=8, seed=1)
    assert np.array_equal(g, p_geo.random_spheres(box=16, porosity=0.6,
                                                  diameter=8, seed=1))
    return g


def _walled():
    """duct_wrap of the spheres: open z ends, extents 18 x 18 x 16 (the
    x/y extents are not multiples of a, so the padding path runs)."""
    g = r_geo.duct_wrap(_spheres())
    assert np.array_equal(g, p_geo.duct_wrap(_spheres()))
    return g


def _tilings(g, to, no):
    return (r_tiling.tile_geometry(g, 4, order=to, node_order=no),
            p_tiling.tile_geometry(g, 4, order=to, node_order=no))


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["D3Q19", "D2Q9"])
def test_lattice_copy(name):
    r, p = r_lat.get_lattice(name), p_lat.get_lattice(name)
    for field in ("e", "w", "opp"):
        _assert_same(getattr(r, field), getattr(p, field))
    assert r.names == p.names
    if name == "D3Q19":
        _assert_same(r_lat.d3q19_mrt_collision_matrix(0.7),
                     p_lat.d3q19_mrt_collision_matrix(0.7))


@pytest.mark.parametrize("case", ["cavity", "duct", "spheres", "vessel",
                                  "aorta", "channel2d"])
def test_geometry_generators_copy(case):
    from repro.launch.lbm import make_case as r_make
    from repro_torch.launch.lbm import make_case as p_make

    r, p = r_make(case, 1), p_make(case, 1)
    _assert_same(r.geometry, p.geometry)
    assert r.periodic == p.periodic and r.lattice == p.lattice
    assert r.force == p.force
    assert [(tv, s.kind, s.normal, s.velocity, s.rho) for tv, s in r.boundaries] \
        == [(tv, s.kind, s.normal, s.velocity, s.rho) for tv, s in p.boundaries]


@pytest.mark.parametrize("tile_order,node_order", ORDERS)
def test_tiling_copy(tile_order, node_order):
    rt, pt = _tilings(_walled(), tile_order, node_order)
    for field in ("tile_coords", "tile_map", "tile_neighbors", "node_types"):
        _assert_same(getattr(rt, field), getattr(pt, field))
    assert (rt.shape, rt.orig_shape, rt.tile_grid) \
        == (pt.shape, pt.orig_shape, pt.tile_grid)
    _assert_same(rt.node_coords(), pt.node_coords())
    vals = np.random.default_rng(0).normal(size=rt.node_types.shape)
    _assert_same(r_tiling.untile(rt, vals, fill=np.nan),
                 p_tiling.untile(pt, vals, fill=np.nan))


@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True),
                                      (False, False, True)])
@pytest.mark.parametrize("tile_order,node_order", ORDERS)
def test_stream_tables_copy(tile_order, node_order, periodic):
    """Monolithic gather table, layout perms and link fractions, on the
    non-aligned walled geometry (periodic wrap per node)."""
    g = _spheres() if any(periodic) else _walled()
    rt, pt = _tilings(g, tile_order, node_order)
    lat_r, lat_p = r_lat.d3q19(), p_lat.d3q19()
    for scheme in ("xyz", "paper"):
        r = r_stream.build_stream_tables(rt, lat_r, scheme, periodic)
        p = p_stream.build_stream_tables(pt, lat_p, scheme, periodic)
        for field in ("gather_idx", "perms", "inv_perms"):
            _assert_same(getattr(r, field), getattr(p, field))
        for field in ("bounce_frac", "cross_tile_frac", "interior_frac",
                      "frontier_frac"):
            assert getattr(r, field) == getattr(p, field), field


@pytest.mark.parametrize("tile_order,node_order",
                         [("zmajor", "canonical"), ("hilbert", "frontier_last")])
def test_stream_table_rows_of_a_tile_subset(tile_order, node_order):
    """``tiles=`` builds exactly the selected rows of the full table."""
    _, pt = _tilings(_walled(), tile_order, node_order)
    lat = p_lat.d3q19()
    full = p_stream.build_stream_tables(pt, lat, "xyz")
    sel = np.random.default_rng(3).choice(pt.num_tiles, 7, replace=False)
    rows = p_stream.build_stream_tables(pt, lat, "xyz", tiles=sel)
    _assert_same(full.gather_idx[:, sel], rows.gather_idx)


@pytest.mark.parametrize("name", ["D3Q19", "D2Q9"])
@pytest.mark.parametrize("node_order", r_tiling.NODE_ORDERS)
def test_pull_geometry_copy(name, node_order):
    r_off, r_perm, r_case = r_sc._pull_geometry(r_lat.get_lattice(name), 4,
                                                node_order)
    lat = p_lat.get_lattice(name)
    p_off, p_perm, p_case = p_sc._pull_geometry(lat, 4, node_order)
    assert r_off == p_off
    _assert_same(r_perm, p_perm)
    _assert_same(r_case, p_case)
    # the kernel's neighbour-slot table names the same source tiles
    slots = p_sc.pull_slots(lat, 4, node_order)
    offs = np.array([(0, 0, 0)] + r_off)[r_case]            # (Q, n, 3)
    want = (offs[..., 0] + 1) + 3 * (offs[..., 1] + 1) + 9 * (offs[..., 2] + 1)
    _assert_same(want.astype(np.int8), slots)


@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, True),
                                      (True, False, False)])
@pytest.mark.parametrize("tile_order", r_tiling.TILE_ORDERS)
def test_neighbor_table_copy(tile_order, periodic):
    rt, pt = _tilings(_spheres(), tile_order, "canonical")
    _assert_same(r_sc.build_neighbor_table(rt, periodic),
                 p_sc.build_neighbor_table(pt, periodic))


def test_neighbor_table_rejects_unaligned_periodic_extent():
    _, pt = _tilings(np.ones((18, 16, 16), np.uint8), "zmajor", "canonical")
    with pytest.raises(ValueError, match="periodic"):
        p_sc.build_neighbor_table(pt, (True, False, False))


@pytest.mark.parametrize("tile_order,node_order",
                         [("zmajor", "canonical"), ("morton", "sfc"),
                          ("morton_slab", "frontier_last")])
def test_boundary_pass_tables_copy(tile_order, node_order):
    """The fused backend's NEBB node tables, built from boundary-tile rows
    only, are the reference's whole-tile tables restricted to the boundary
    nodes: in tile and slot order, each with its spec index and the
    reference's packed gather column."""
    g = r_geo.duct_wrap(_spheres(), wall=4)
    rt, pt = _tilings(g, tile_order, node_order)
    r_bcs = ((r_tiling.INLET, RSpec("velocity", (0, 0, 1))),
             (r_tiling.OUTLET, RSpec("pressure", (0, 0, -1))))
    p_bcs = ((p_tiling.INLET, PSpec("velocity", (0, 0, 1))),
             (p_tiling.OUTLET, PSpec("pressure", (0, 0, -1))))
    lat_r, lat_p = r_lat.d3q19(), p_lat.d3q19()
    gi = r_stream.build_stream_tables(rt, lat_r, "xyz").gather_idx
    r_tiles, r_packed, r_masks, _ = r_boundary_tables(rt.node_types, gi, r_bcs, 19, 64)
    p = p_boundary_tables(pt, lat_p, p_bcs, (False, False, False))
    assert len(r_tiles) < rt.num_tiles and p.num_tiles == pt.num_tiles
    j, slots = np.nonzero(r_masks.any(axis=0))
    _assert_same(p.tiles, r_tiles[j])
    _assert_same(p.slots, slots.astype(np.int32))
    _assert_same(p.spec, r_masks[:, j, slots].argmax(axis=0).astype(np.uint8))
    _assert_same(p.src, r_packed[:, j, slots])
    absent = ((7, p_bcs[0][1]),)
    assert p_boundary_tables(pt, lat_p, absent, (False,) * 3) is None


@pytest.mark.parametrize("periodic", [(False,) * 3, (True, True, False)])
@pytest.mark.parametrize("tile_order,node_order", [("zmajor", "canonical"),
                                                   ("hilbert", "sfc")])
def test_boundary_nodes_listed_once(tile_order, node_order, periodic):
    """Every node of a declared boundary type is listed once, with the index
    of its type's spec; no other node is listed."""
    _, pt = _tilings(r_geo.duct_wrap(_spheres(), wall=4), tile_order, node_order)
    bcs = ((p_tiling.OUTLET, PSpec("pressure", (0, 0, -1))),
           (p_tiling.INLET, PSpec("velocity", (0, 0, 1))))
    p = p_boundary_tables(pt, p_lat.d3q19(), bcs, periodic)
    n = pt.nodes_per_tile
    node = p.tiles.astype(np.int64) * n + p.slots
    assert len(np.unique(node)) == len(node) and np.all(np.diff(node) > 0)
    types = pt.node_types.reshape(-1)
    want = np.nonzero(np.isin(types, (p_tiling.INLET, p_tiling.OUTLET)))[0]
    _assert_same(node, want)
    _assert_same(np.array([bcs[k][0] for k in p.spec], np.uint8), types[node])
    assert p.src.shape == (19, len(node)) and p.src.flags.c_contiguous
    assert 0 <= p.src.min() and p.src.max() < pt.num_tiles * 19 * n
    with pytest.raises(ValueError, match="twice"):
        p_boundary_tables(pt, p_lat.d3q19(), bcs + bcs[:1], periodic)


def _cuh_array(src, q, fn):
    body = src[src.index(f"struct Stencil<{q}>"):]
    body = body[body.index(f" {fn}("):]
    m = re.search(r"\{([-0-9, ]+)\}", body)
    return np.array([int(v) for v in m.group(1).split(",")], np.int32)


@pytest.mark.parametrize("name", ["D3Q19", "D2Q9"])
def test_cuda_stencil_constants_match_lattice(name):
    """The direction vectors and opposites compiled into the kernels
    (csrc/collide.cuh) are the lattice module's."""
    import repro_torch

    src = (Path(repro_torch.__file__).parent / "csrc" / "collide.cuh").read_text()
    lat = p_lat.get_lattice(name)
    axes = ("ex", "ey", "ez") if lat.q == 19 else ("ex", "ey")
    for k, fn in enumerate(axes):
        _assert_same(_cuh_array(src, lat.q, fn), lat.e[:, k])
    _assert_same(_cuh_array(src, lat.q, "opp"), lat.opp)
