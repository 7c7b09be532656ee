"""Per-direction data-block layouts — the paper's Eqns (11)-(13) (numpy).

A copy of ``repro.core.layouts``, kept here so that the port never imports
the JAX package: the stream tables read the permutations, and the paper's
transaction model (§3.2, Table 5) counts what each layout costs.  The linear
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


def l_xyz(x, y, z, a: int = 4):
    return x + a * y + a * a * z


def l_yxz(x, y, z, a: int = 4):
    return y + a * x + a * a * z


def l_zigzag_ne(x, y, z, a: int = 4):
    return _l_zigzag_ne_table(a)[x, y, z]


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
        off = l_xyz(x, y, z, a)
    elif layout == YXZ:
        off = l_yxz(x, y, z, a)
    elif layout == ZIGZAG_NE:
        off = _l_zigzag_ne_table(a)[x, y, z]
    else:
        raise ValueError(f"unknown layout {layout!r}")
    off = np.asarray(off, dtype=np.int32)
    assert sorted(off.tolist()) == list(range(a ** 3)), f"{layout} not a bijection"
    return off


@lru_cache(maxsize=None)
def inverse_permutation(layout: str, a: int = 4) -> np.ndarray:
    """inv such that canonical_index = inv[layout_offset]."""
    perm = layout_permutation(layout, a)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return inv


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


# --------------------------------------------------------------------------
# Transaction model (paper §3.2, Table 5): the 32-byte transactions needed
# to pull one f_i data block during propagation, given the layout.
# --------------------------------------------------------------------------
def transactions_for_direction(
    e_i: tuple[int, int, int],
    layout: str,
    a: int = 4,
    value_bytes: int = 8,
    transaction_bytes: int = 32,
) -> int:
    """Number of 32-byte transactions to gather f_i for one full tile.

    Pull streaming: node (x,y,z) of the current tile reads f_i from node
    (x,y,z) - e_i, which lives either in this tile's data block or in a
    neighbour tile's block (at wrapped coordinates).  Every distinct
    transaction-aligned segment touched in any source block counts once:
    the paper's coalescing model."""
    per_tx = transaction_bytes // value_bytes
    n = np.arange(a ** 3)
    xs, ys, zs = n % a, (n // a) % a, n // (a * a)
    offsets = layout_permutation(layout, a)

    touched: dict[tuple[int, int, int], set[int]] = {}
    ex, ey, ez = e_i
    for x, y, z, _ in zip(xs, ys, zs, offsets):
        sx, sy, sz = x - ex, y - ey, z - ez
        tile = (sx // a, sy // a, sz // a)  # which neighbour block
        lx, ly, lz = sx % a, sy % a, sz % a
        src_off = int(offsets[lx + a * ly + a * a * lz])
        touched.setdefault(tile, set()).add(src_off // per_tx)
    return sum(len(s) for s in touched.values())


def transactions_per_tile(
    lattice: Lattice,
    scheme: str = "paper",
    a: int = 4,
    value_bytes: int = 8,
    transaction_bytes: int = 32,
) -> dict[str, int]:
    """Transactions per direction for a full interior tile (paper §3.2)."""
    layouts = direction_layouts(lattice, scheme)
    return {
        name: transactions_for_direction(
            tuple(lattice.e[i]), layouts[i], a, value_bytes, transaction_bytes
        )
        for i, name in enumerate(lattice.names)
    }
