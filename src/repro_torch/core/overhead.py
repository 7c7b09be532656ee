"""Tile-utilisation studies — paper §3.3, Figs 8-10 (numpy; a copy of the
reference's ``repro.core.overhead``, so that the port never imports the
JAX package).

Average tile utilisation eta_t for all possible tilings of infinitely long
square and circular channels running along an axis.  "All tilings" = the a^2
(=16 for a=4) distinct offsets of the tile mesh relative to the channel
cross-section (tile positions are discrete, paper Fig. 9).
"""
from __future__ import annotations

import numpy as np


def _channel_cross_section(kind: str, size: int, pad: int) -> np.ndarray:
    """Boolean fluid mask of the channel cross-section inside a padded box."""
    n = size + 2 * pad
    if kind == "square":
        m = np.zeros((n, n), dtype=bool)
        m[pad : pad + size, pad : pad + size] = True
        return m
    if kind == "circle":
        c = pad + size / 2.0 - 0.5
        yy, xx = np.mgrid[0:n, 0:n]
        return (xx - c) ** 2 + (yy - c) ** 2 <= (size / 2.0) ** 2
    raise ValueError(kind)


def channel_tile_utilisations(kind: str, size: int, a: int = 4) -> np.ndarray:
    """eta_t for each of the a^2 tilings of an infinite channel (Figs 8/10).

    The channel runs along z, so a tile column is non-empty iff its (x, y)
    footprint overlaps the cross-section; utilisation along z is uniform.
    """
    etas = []
    for ox in range(a):
        for oy in range(a):
            # FIXED pad: the channel starts at index a; slicing the window
            # by (ox, oy) shifts the tile mesh to all a^2 distinct offsets.
            mask = _channel_cross_section(kind, size, pad=a)
            sub = mask[ox:, oy:]
            hx = (-sub.shape[0]) % a
            hy = (-sub.shape[1]) % a
            sub = np.pad(sub, ((0, hx), (0, hy)))
            tx, ty = sub.shape[0] // a, sub.shape[1] // a
            blocks = sub.reshape(tx, a, ty, a)
            per_tile = blocks.sum(axis=(1, 3))          # fluid nodes per tile
            non_empty = per_tile > 0
            tiles = int(non_empty.sum())
            fluid = int(per_tile.sum())
            etas.append(fluid / (tiles * a * a) if tiles else 0.0)
    return np.asarray(etas)


def channel_utilisation_stats(kind: str, sizes, a: int = 4):
    """(size, min, mean, max) rows over all tilings — the Fig 8/10 curves."""
    rows = []
    for s in sizes:
        etas = channel_tile_utilisations(kind, int(s), a)
        rows.append((int(s), float(etas.min()), float(etas.mean()), float(etas.max())))
    return rows
