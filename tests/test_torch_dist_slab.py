"""Host-side slab-plan properties of the port (``repro_torch.dist.lbm``):
the counterparts of ``tests/test_dist_slab.py`` and of
``tests/test_tile_order.py``'s slab checks, on the port's own tiler,
stream tables and geometries."""
import numpy as np
import pytest

from repro_torch.core.lattice import get_lattice
from repro_torch.core.streaming import build_stream_tables
from repro_torch.core.tiling import (FLUID, INLET, OUTLET,
                                     SLAB_COMPATIBLE_ORDERS, SOLID,
                                     tile_geometry)
from repro_torch.data import geometry as geo
from repro_torch.dist.lbm import (_tiles_at_layer, balanced_layer_partition,
                                  halo_lists, make_slab_plan)


def _duct():
    return geo.duct(12, 12, 48, open_ends=True)


def test_partition_balanced_uniform():
    """Equal-weight layers split into equal contiguous slabs."""
    parts = balanced_layer_partition(np.ones(16), 4)
    assert parts == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert balanced_layer_partition(np.ones(8), 8) == [
        (i, i + 1) for i in range(8)]


def test_partition_balanced_weighted():
    """Cuts track cumulative weight, every slab gets >= 1 layer."""
    w = np.array([100, 1, 1, 1, 1, 1, 1, 100], float)
    parts = balanced_layer_partition(w, 4)
    assert parts[0] == (0, 1)             # the heavy layer stands alone
    assert parts[-1][1] == 8
    assert all(zh > zl for zl, zh in parts)
    assert all(parts[i][1] == parts[i + 1][0] for i in range(3))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_slab_plan_fluid_conservation(n_dev):
    """Owned fluid nodes over all slabs == global fluid nodes, and owned
    tile sets are disjoint by construction (distinct z layers)."""
    g = _duct()
    plan = make_slab_plan(g, 4, n_dev)
    assert plan.n_fluid_own == tile_geometry(g, 4).n_fluid_nodes
    counts = [zh - zl for zl, zh in plan.layer_of_dev]
    assert max(counts) - min(counts) <= 1


def test_slab_plan_layers_cover_grid():
    plan = make_slab_plan(_duct(), 4, 3)
    assert plan.layer_of_dev[0][0] == 0
    assert plan.layer_of_dev[-1][1] == plan.tile_layers
    for d in range(plan.n_dev - 1):
        assert plan.layer_of_dev[d][1] == plan.layer_of_dev[d + 1][0]


@pytest.mark.parametrize("periodic_z", [False, True])
def test_cross_slab_links_resolve_in_halo(periodic_z):
    """Every streaming link out of an owned tile resolves inside the owned
    layers or into a halo tile layer — never out of the slab — and the
    slabs with a halo do link into it; with periodic z the end slabs get
    the wrapped halo."""
    plan = make_slab_plan(_duct(), 4, 4, periodic_z=periodic_z)
    lat = get_lattice("D3Q19")
    n = plan.nodes_per_tile
    for d, lt in enumerate(plan.local_tilings):
        tabs = build_stream_tables(lt, lat, "paper")
        m = lt.num_tiles * n
        src_tile = (tabs.gather_idx.astype(np.int64) % m) // n  # (Q, T, n)
        lo, hi = plan.owned_layer_range_local(d)
        halo = set(plan.halo_layers_local(d))
        assert len(halo) == (2 if periodic_z or 0 < d < 3 else 1)
        owned_tiles = np.nonzero(plan.own[d, :lt.num_tiles])[0]
        src_layers = lt.tile_coords[src_tile[:, owned_tiles], 2]
        ok = (src_layers >= lo) & (src_layers < hi)
        for hl in halo:
            ok |= src_layers == hl
        assert ok.all(), f"slab {d}: link escapes the slab+halo region"
        outside = (src_layers < lo) | (src_layers >= hi)
        assert outside.any()


def test_slab_plan_own_excludes_halo_and_padding():
    plan = make_slab_plan(_duct(), 4, 3)
    for d, lt in enumerate(plan.local_tilings):
        lo, hi = plan.owned_layer_range_local(d)
        own_d = plan.own[d]
        assert not own_d[lt.num_tiles:].any()          # padding + dummy
        zc = lt.tile_coords[:, 2]
        np.testing.assert_array_equal(own_d[:lt.num_tiles],
                                      (zc >= lo) & (zc < hi))


def test_duct_wrap_closes_porous_block():
    g = geo.random_spheres(box=24, porosity=0.7, diameter=8, seed=1)
    w = geo.duct_wrap(g)
    assert w.shape == (26, 26, 24)
    assert (w[0] == SOLID).all() and (w[-1] == SOLID).all()
    assert (w[:, 0] == SOLID).all() and (w[:, -1] == SOLID).all()
    np.testing.assert_array_equal(w[1:-1, 1:-1, 0] == INLET,
                                  g[:, :, 0] == FLUID)
    np.testing.assert_array_equal(w[1:-1, 1:-1, -1] == OUTLET,
                                  g[:, :, -1] == FLUID)


def _porous():
    return geo.duct_wrap(geo.random_spheres(box=16, porosity=0.6, diameter=8,
                                            seed=1), wall=4)


def test_slab_plan_rejects_global_curves():
    for order in ("morton", "hilbert"):
        with pytest.raises(ValueError, match="slab-compatible"):
            make_slab_plan(_porous(), 4, 2, tile_order=order)
    assert set(SLAB_COMPATIBLE_ORDERS) == {"zmajor", "morton_slab"}


@pytest.mark.parametrize("order", SLAB_COMPATIBLE_ORDERS)
def test_slab_plan_halo_rows_align(order):
    """Neighbouring slabs enumerate a shared tile layer identically, so
    every hop's send and receive rows are the same tiles, element for
    element."""
    plan = make_slab_plan(_porous(), 4, 2, tile_order=order)
    assert plan.tile_order == order
    assert 0 < plan.tile_utilisation <= 1
    hops, _ = halo_lists(plan)
    assert len(hops) == 2
    for h in hops:
        src, dst = plan.local_tilings[h.src], plan.local_tilings[h.dst]
        shift = (plan.layer_of_dev[h.src][0] - plan.own_z0[h.src]) \
            - (plan.layer_of_dev[h.dst][0] - plan.own_z0[h.dst])
        a, b = src.tile_coords[h.send], dst.tile_coords[h.recv]
        np.testing.assert_array_equal(a[:, :2], b[:, :2])
        np.testing.assert_array_equal(a[:, 2] + shift, b[:, 2])
        assert len(_tiles_at_layer(dst, b[0, 2])) == len(h.recv)
