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
