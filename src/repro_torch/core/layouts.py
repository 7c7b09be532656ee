"""Per-direction data-block layouts — the paper's Eqns (11)-(13) (numpy).

A copy of the parts of ``repro.core.layouts`` that the stream tables need,
kept here so that the port never imports the JAX package.  The linear
mapping L(x, y, z) -> offset places each node's f_i value inside the tile's
data block for direction i:

* L_XYZ     = x + 4y + 16z                      (Eqn 11, row order)
* L_YXZ     = y + 4x + 16z                      (Eqn 12, x/y swapped)
* L_zigzagNE: consecutive offsets pair the two z values of each (x, y)
  column, (x, y) ordered along north-east anti-diagonals (Fig. 7).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .lattice import Lattice

XYZ = "XYZ"
YXZ = "YXZ"
ZIGZAG_NE = "zigzagNE"

PAPER_ASSIGNMENT = {
    "O": XYZ, "N": XYZ, "S": XYZ, "T": XYZ, "B": XYZ,
    "NT": XYZ, "NB": XYZ, "ST": XYZ, "SB": XYZ,
    "E": YXZ, "W": YXZ, "ET": YXZ, "EB": YXZ,
    "NW": YXZ, "SW": YXZ, "WT": YXZ, "WB": YXZ,
    "NE": ZIGZAG_NE, "SE": ZIGZAG_NE,
}


def _zigzag_rank(a: int = 4) -> np.ndarray:
    """(a, a) rank of each (x, y) for the zigzagNE layout: the y = 0 row,
    the interior core in NE anti-diagonal order, the y = a-1 row, then the
    x = a-1 column."""
    order: list[tuple[int, int]] = []
    order += [(x, 0) for x in range(a - 1)]
    core = sorted(
        ((x + y, x, y) for x in range(a - 1) for y in range(1, a - 1))
    )
    order += [(x, y) for (_, x, y) in core]
    order += [(x, a - 1) for x in range(a - 1)]
    order += [(a - 1, y) for y in range(a)]
    rank = np.zeros((a, a), dtype=np.int64)
    for r, (x, y) in enumerate(order):
        rank[x, y] = r
    return rank


def _l_zigzag_ne_table(a: int = 4) -> np.ndarray:
    """offset[x, y, z] for the zigzagNE layout."""
    rank = _zigzag_rank(a)
    half = a // 2
    off = np.zeros((a, a, a), dtype=np.int64)
    for x in range(a):
        for y in range(a):
            for z in range(a):
                off[x, y, z] = (z // half) * (a * a * half) + 2 * rank[x, y] + (z % half)
    return off


@lru_cache(maxsize=None)
def layout_permutation(layout: str, a: int = 4) -> np.ndarray:
    """perm such that block[perm[i]] = value of node with canonical offset i."""
    n = np.arange(a ** 3)
    x, y, z = n % a, (n // a) % a, n // (a * a)
    if layout == XYZ:
        off = x + a * y + a * a * z
    elif layout == YXZ:
        off = y + a * x + a * a * z
    elif layout == ZIGZAG_NE:
        off = _l_zigzag_ne_table(a)[x, y, z]
    else:
        raise ValueError(f"unknown layout {layout!r}")
    off = np.asarray(off, dtype=np.int32)
    assert sorted(off.tolist()) == list(range(a ** 3)), f"{layout} not a bijection"
    return off


def direction_layouts(lattice: Lattice, scheme: str = "paper") -> list[str]:
    """Layout name per direction index.

    scheme: 'paper' (XYZ+YXZ+zigzagNE), 'xyz' (all XYZ), 'xyz+yxz',
    'xyz+zigzag' — the four rows of the paper's Table 5.
    """
    if lattice.q != 19 and scheme != "xyz":
        scheme = "xyz"  # paper assignment is D3Q19-specific
    if scheme == "xyz":
        return [XYZ] * lattice.q
    full = [PAPER_ASSIGNMENT[name] for name in lattice.names]
    if scheme == "paper":
        return full
    if scheme == "xyz+yxz":
        return [l if l == YXZ else XYZ for l in full]
    if scheme == "xyz+zigzag":
        return [l if l == ZIGZAG_NE else XYZ for l in full]
    raise ValueError(f"unknown layout scheme {scheme!r}")
