"""The port's copies of the paper's counting tools are byte-equal to the
JAX package's: the layout mappings and the transaction model of §3.2
(``core.layouts``), the tile-utilisation studies of §3.3, Figs 8-10
(``core.overhead``), and the all-fluid box (``data.geometry``)."""
import numpy as np
import pytest

from repro.core import lattice as r_lat
from repro.core import layouts as r_lay
from repro.core import overhead as r_over
from repro.data import geometry as r_geo
from repro_torch.core import lattice as p_lat
from repro_torch.core import layouts as p_lay
from repro_torch.core import overhead as p_over
from repro_torch.data import geometry as p_geo

LAYOUTS = (r_lay.XYZ, r_lay.YXZ, r_lay.ZIGZAG_NE)
LATTICES = ("D3Q19", "D2Q9")
SCHEMES = ("paper", "xyz", "xyz+yxz", "xyz+zigzag")


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("a", (2, 4))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mappings_and_inverse_permutations(layout, a):
    n = np.arange(a ** 3)
    x, y, z = n % a, (n // a) % a, n // (a * a)
    fn = {r_lay.XYZ: "l_xyz", r_lay.YXZ: "l_yxz", r_lay.ZIGZAG_NE: "l_zigzag_ne"}[layout]
    _same(getattr(p_lay, fn)(x, y, z, a), getattr(r_lay, fn)(x, y, z, a))
    if layout == r_lay.ZIGZAG_NE and a != 4:
        # the reconstruction of Eqn 13 is a bijection at the paper's a = 4
        # only; both packages refuse other edges
        for mod in (r_lay, p_lay):
            with pytest.raises(AssertionError, match="bijection"):
                mod.inverse_permutation(layout, a)
        return
    _same(p_lay.inverse_permutation(layout, a), r_lay.inverse_permutation(layout, a))
    perm = p_lay.layout_permutation(layout, a)
    _same(perm[p_lay.inverse_permutation(layout, a)], n.astype(np.int32))


@pytest.mark.parametrize("value_bytes", (4, 8))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("lattice", LATTICES)
def test_transactions_per_tile(lattice, scheme, value_bytes):
    """Every direction's count (the paper's Table 5 rows), and the count for
    each direction under each layout by itself."""
    r_l, p_l = r_lat.get_lattice(lattice), p_lat.get_lattice(lattice)
    got = p_lay.transactions_per_tile(p_l, scheme, value_bytes=value_bytes)
    want = r_lay.transactions_per_tile(r_l, scheme, value_bytes=value_bytes)
    assert got == want and list(got) == list(want)
    assert all(type(v) is int for v in got.values())
    for e in r_l.e:
        for layout in LAYOUTS:
            assert (p_lay.transactions_for_direction(tuple(e), layout, value_bytes=value_bytes)
                    == r_lay.transactions_for_direction(tuple(e), layout,
                                                        value_bytes=value_bytes))


def test_paper_counts_for_the_zigzag_directions():
    """The paper's 16 + 4 double-precision transactions for f_NE and f_SE
    under L_zigzagNE (§3.2), against 32 under L_XYZ."""
    counts = p_lay.transactions_per_tile(p_lat.get_lattice("D3Q19"), "paper")
    xyz = p_lay.transactions_per_tile(p_lat.get_lattice("D3Q19"), "xyz")
    assert counts["NE"] == counts["SE"] == 20
    assert counts["NE"] < xyz["NE"]


@pytest.mark.parametrize("kind", ("square", "circle"))
def test_channel_tile_utilisations(kind):
    for size in range(1, 65):
        _same(p_over.channel_tile_utilisations(kind, size),
              r_over.channel_tile_utilisations(kind, size))
    sizes = list(range(1, 65, 7))
    assert p_over.channel_utilisation_stats(kind, sizes) == \
        r_over.channel_utilisation_stats(kind, sizes)
    with pytest.raises(ValueError):
        p_over.channel_tile_utilisations("hexagon", 8)


def test_open_channel3d():
    for shape in ((1, 1, 1), (4, 8, 12), (17, 5, 9)):
        _same(p_geo.open_channel3d(*shape), r_geo.open_channel3d(*shape))


# --------------------------------------------------------------------------
# the tiling's locality and overhead accounting, the stream tables' link
# distances, and the collision's FLOP count (ROADMAP §1 item 8)
# --------------------------------------------------------------------------
from repro.core import collision as r_col  # noqa: E402
from repro.core import streaming as r_st  # noqa: E402
from repro.core import tiling as r_til  # noqa: E402
from repro_torch.core import collision as p_col  # noqa: E402
from repro_torch.core import streaming as p_st  # noqa: E402
from repro_torch.core import tiling as p_til  # noqa: E402

GEOMETRIES = {"channel": (4, 8, 12), "odd": (17, 5, 9),
              "duct": lambda g: g.duct(12, 10, 16)}


def _geometry(mod, name):
    shape = GEOMETRIES[name]
    return shape(mod) if callable(shape) else mod.open_channel3d(*shape)


@pytest.mark.parametrize("node_order", ("canonical", "sfc"))
@pytest.mark.parametrize("order", ("zmajor", "morton", "hilbert"))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_tiling_locality_and_overheads(geometry, order, node_order):
    rt = r_til.tile_geometry(_geometry(r_geo, geometry), 4, order=order, node_order=node_order)
    pt = p_til.tile_geometry(_geometry(p_geo, geometry), 4, order=order, node_order=node_order)
    assert pt.overhead_generic() == rt.overhead_generic()
    for args in ((), (19, 4), (9, 8, 2)):
        assert pt.overhead_memory(*args) == rt.overhead_memory(*args)
    _same(pt.neighbor_index_distances(), rt.neighbor_index_distances())
    assert pt.mean_neighbor_index_distance() == rt.mean_neighbor_index_distance()
    assert pt.neighbor_index_distance_hist() == rt.neighbor_index_distance_hist()
    assert pt.locality_metrics() == rt.locality_metrics()
    for lat in (None, "D3Q19", "D2Q9"):
        e = None if lat is None else r_lat.get_lattice(lat).e
        _same(pt.intra_tile_link_distances(e), rt.intra_tile_link_distances(e))
        assert pt.mean_intra_tile_link_distance(e) == rt.mean_intra_tile_link_distance(e)
    dense = np.random.default_rng(0).standard_normal((2,) + pt.orig_shape)
    _same(p_til.tile_field(pt, dense), r_til.tile_field(rt, dense))


def test_pow2_hist():
    for counts in ([], [0], [3], [1, 0, 2, 0, 0, 7], list(range(10))):
        assert p_til.pow2_hist(np.asarray(counts)) == r_til.pow2_hist(np.asarray(counts))


@pytest.mark.parametrize("periodic", ((False, False, False), (False, False, True)))
@pytest.mark.parametrize("order", ("zmajor", "morton"))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_stream_table_link_distances(geometry, order, periodic):
    lat_r, lat_p = r_lat.get_lattice("D3Q19"), p_lat.get_lattice("D3Q19")
    rt = r_til.tile_geometry(_geometry(r_geo, geometry), 4, order=order)
    pt = p_til.tile_geometry(_geometry(p_geo, geometry), 4, order=order)
    want = r_st.build_stream_tables(rt, lat_r, "xyz", periodic)
    got = p_st.build_stream_tables(pt, lat_p, "xyz", periodic)
    assert got.mean_link_distance == want.mean_link_distance
    assert got.link_distance_hist == want.link_distance_hist
    assert got.index_entries_mono == want.index_entries_mono


@pytest.mark.parametrize("lattice", LATTICES)
def test_model_flops_per_node(lattice):
    for model in ("lbgk", "lbmrt"):
        for fluid in ("incompressible", "quasi_compressible"):
            assert p_col.model_flops_per_node(
                p_col.CollisionConfig(model=model, fluid=fluid), p_lat.get_lattice(lattice)) == \
                r_col.model_flops_per_node(r_col.CollisionConfig(model=model, fluid=fluid),
                                           r_lat.get_lattice(lattice))
