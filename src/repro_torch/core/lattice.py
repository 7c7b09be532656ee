"""Lattice definitions for the LBM solver (numpy).

A copy of ``repro.core.lattice``: the port keeps its own so that it never
imports the JAX package.  D3Q19 is the paper's lattice (Tomczak & Szafran
2016, Fig. 1); D2Q9 is kept for cheap 2-D validation tests.

Direction naming follows the paper: E=+x, N=+y, T=+z (W/S/B are the
opposites).  Index 0 is the rest direction O.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# --------------------------------------------------------------------------
# D3Q19
# --------------------------------------------------------------------------
# name -> unit direction vector e_i (paper Fig. 1 naming convention).
D3Q19_NAMES = (
    "O",
    "E", "N", "W", "S", "T", "B",
    "NE", "NW", "SW", "SE",
    "ET", "NT", "WT", "ST",
    "EB", "NB", "WB", "SB",
)

_D3Q19_E = np.array(
    [
        (0, 0, 0),
        (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
        (1, 1, 0), (-1, 1, 0), (-1, -1, 0), (1, -1, 0),
        (1, 0, 1), (0, 1, 1), (-1, 0, 1), (0, -1, 1),
        (1, 0, -1), (0, 1, -1), (-1, 0, -1), (0, -1, -1),
    ],
    dtype=np.int32,
)

_D3Q19_W = np.array(
    [1.0 / 3.0]
    + [1.0 / 18.0] * 6
    + [1.0 / 36.0] * 12,
    dtype=np.float64,
)

# --------------------------------------------------------------------------
# D2Q9 (for cheap validation tests)
# --------------------------------------------------------------------------
D2Q9_NAMES = ("O", "E", "N", "W", "S", "NE", "NW", "SW", "SE")

_D2Q9_E = np.array(
    [
        (0, 0, 0),
        (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0),
        (1, 1, 0), (-1, 1, 0), (-1, -1, 0), (1, -1, 0),
    ],
    dtype=np.int32,
)

_D2Q9_W = np.array(
    [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float64
)


def _opposites(e: np.ndarray) -> np.ndarray:
    """Index of the direction with e_opp = -e_i, for bounce-back."""
    opp = np.zeros(len(e), dtype=np.int32)
    for i, ei in enumerate(e):
        (j,) = np.nonzero((e == -ei).all(axis=1))[0]
        opp[i] = j
    return opp


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: usable as a
class Lattice:                                 # static jit arg (singletons)
    """An immutable DdQq lattice stencil."""

    name: str
    d: int                      # space dimension
    q: int                      # number of lattice links
    e: np.ndarray               # (q, 3) int32 direction vectors
    w: np.ndarray               # (q,) float64 quadrature weights
    opp: np.ndarray             # (q,) int32 opposite-direction index
    names: tuple[str, ...]

    # lattice constants
    cs2: float = 1.0 / 3.0      # speed of sound squared

    def __post_init__(self):
        assert self.e.shape == (self.q, 3)
        assert abs(self.w.sum() - 1.0) < 1e-12
        assert (self.e[self.opp] == -self.e).all()

    @property
    def ex(self) -> np.ndarray:
        return self.e[:, 0]

    @property
    def ey(self) -> np.ndarray:
        return self.e[:, 1]

    @property
    def ez(self) -> np.ndarray:
        return self.e[:, 2]

    def direction(self, name: str) -> int:
        return self.names.index(name)


@lru_cache(maxsize=None)
def d3q19() -> Lattice:
    return Lattice(
        name="D3Q19", d=3, q=19, e=_D3Q19_E, w=_D3Q19_W,
        opp=_opposites(_D3Q19_E), names=D3Q19_NAMES,
    )


@lru_cache(maxsize=None)
def d2q9() -> Lattice:
    return Lattice(
        name="D2Q9", d=2, q=9, e=_D2Q9_E, w=_D2Q9_W,
        opp=_opposites(_D2Q9_E), names=D2Q9_NAMES,
    )


def get_lattice(name: str) -> Lattice:
    name = name.upper()
    if name == "D3Q19":
        return d3q19()
    if name == "D2Q9":
        return d2q9()
    raise ValueError(f"unknown lattice {name!r}")


# --------------------------------------------------------------------------
# MRT (multiple-relaxation-time) moment basis for D3Q19
# --------------------------------------------------------------------------
# d'Humieres et al. (2002) orthogonal moment basis.  Rows are the 19 moments
# (rho, e, eps, jx, qx, jy, qy, jz, qz, 3pxx, 3pixx, pww, piww, pxy, pyz,
#  pxz, mx, my, mz) expressed as polynomials of the direction vectors.
@lru_cache(maxsize=None)
def d3q19_mrt_matrix() -> np.ndarray:
    lat = d3q19()
    ex, ey, ez = lat.ex.astype(np.float64), lat.ey.astype(np.float64), lat.ez.astype(np.float64)
    e2 = ex * ex + ey * ey + ez * ez
    rows = [
        np.ones(19),
        19.0 * e2 - 30.0,
        (21.0 * e2 * e2 - 53.0 * e2 + 24.0) / 2.0,
        ex,
        (5.0 * e2 - 9.0) * ex,
        ey,
        (5.0 * e2 - 9.0) * ey,
        ez,
        (5.0 * e2 - 9.0) * ez,
        3.0 * ex * ex - e2,
        (3.0 * e2 - 5.0) * (3.0 * ex * ex - e2),
        ey * ey - ez * ez,
        (3.0 * e2 - 5.0) * (ey * ey - ez * ez),
        ex * ey,
        ey * ez,
        ex * ez,
        ex * (ey * ey - ez * ez),
        ey * (ez * ez - ex * ex),
        ez * (ex * ex - ey * ey),
    ]
    m = np.stack(rows).astype(np.float64)
    # sanity: rows orthogonal
    g = m @ m.T
    assert np.allclose(g - np.diag(np.diag(g)), 0.0, atol=1e-9)
    return m


@lru_cache(maxsize=None)
def d3q19_mrt_relaxation(tau: float) -> np.ndarray:
    """Standard relaxation-rate vector; s9 = s13 = 1/tau sets viscosity.

    Conserved moments (rho, j) have rate 0 (any value works since their
    non-equilibrium part vanishes; 0 makes the invariance explicit).
    """
    s_nu = 1.0 / tau
    s = np.zeros(19, dtype=np.float64)
    s[1] = 1.19
    s[2] = 1.4
    s[4] = s[6] = s[8] = 1.2
    s[9] = s[11] = s[13] = s[14] = s[15] = s_nu
    s[10] = s[12] = 1.4
    s[16] = s[17] = s[18] = 1.98
    return s


def d3q19_mrt_collision_matrix(tau: float, equal_rates: bool = False) -> np.ndarray:
    """A = M^-1 S M — the paper's Eqn (8) collision matrix.

    With ``equal_rates=True`` every rate is 1/tau and A reduces exactly to
    (1/tau) * I, i.e. LBGK — used as a consistency test.
    """
    m = d3q19_mrt_matrix()
    if equal_rates:
        s = np.full(19, 1.0 / tau)
    else:
        s = d3q19_mrt_relaxation(tau)
    minv = np.linalg.inv(m)
    return (minv * s) @ m
