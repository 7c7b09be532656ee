"""Streaming (propagation) index builder for the sparse tiled engine (numpy).

The port's copy of the monolithic path of ``repro.core.streaming``.  For
every (direction, tile, node) the host precomputes the flat index of the
pull source, folding in the per-direction data-block layout, the within-tile
node enumeration, cross-tile links through the tile map, half-way
bounce-back at solid nodes and optional periodic axes.  Streaming is then
ONE gather per direction from the flattened (Q * T * a^3) state.

The table is built in chunks of tiles, and ``tiles=`` restricts it to a
subset: the fused backend needs rows only for the tiles that hold open
boundary nodes, which at full size is a few percent of a table that would
otherwise cost most of the engine's set-up time.  Every row holds the same
values as the corresponding row of the full table (pinned by test).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .lattice import Lattice
from .layouts import XYZ, direction_layouts, layout_permutation
from .tiling import SOLID, Tiling

_CHUNK_TILES = 4096


@dataclasses.dataclass
class StreamTables:
    """Precomputed streaming tables over a set of destination tiles.

    The link fractions count fluid destinations in those tiles, moving
    directions only: interior + frontier + bounce == 1.
    """

    gather_idx: np.ndarray     # (Q, B, n) int32 into flat (Q*T*n) storage
    perms: np.ndarray          # (Q, n) int32 node-axis slot -> storage slot
    inv_perms: np.ndarray      # (Q, n) int32 storage slot -> node-axis slot
    bounce_frac: float
    cross_tile_frac: float
    interior_frac: float
    frontier_frac: float


def layout_perms(tiling: Tiling, lat: Lattice, layout_scheme: str):
    """Per-direction placement tables of ``layout_scheme``.

    Returns ``(eff_perms, slot_perms, inv_perms)``, all (Q, n) int64:
    canonical offset -> storage slot, node-axis slot -> storage slot, and
    storage slot -> node-axis slot.  The XYZ layout follows the node_order
    slot enumeration; the other layouts keep their own placement.
    """
    a, n = tiling.a, tiling.nodes_per_tile
    node_perm = tiling.node_perm
    eff = np.stack(
        [node_perm if l == XYZ else layout_permutation(l, a).astype(np.int64)
         for l in direction_layouts(lat, layout_scheme)])
    slot = eff[:, tiling.node_of_slot]
    inv = np.empty_like(slot)
    for q in range(lat.q):
        inv[q][slot[q]] = np.arange(n, dtype=np.int64)
    return eff, slot, inv


def build_stream_tables(
    tiling: Tiling,
    lat: Lattice,
    layout_scheme: str = "xyz",
    periodic: tuple[bool, bool, bool] = (False, False, False),
    tiles: np.ndarray | None = None,
) -> StreamTables:
    """Pull-streaming gather rows for ``tiles`` (default: every tile)."""
    a, n = tiling.a, tiling.nodes_per_tile
    m = tiling.num_tiles * n
    dims = np.array(tiling.shape, dtype=np.int64)
    # periodic wrap must use the ORIGINAL extent (padding is solid filler)
    wrap_dims = np.array(tiling.orig_shape, dtype=np.int64)
    eff_perms, slot_perms, inv_perms = layout_perms(tiling, lat, layout_scheme)
    node_perm = tiling.node_perm
    c = tiling.node_of_slot
    local = np.stack([c % a, (c // a) % a, c // (a * a)], axis=-1)  # (n, 3)
    sel = (np.arange(tiling.num_tiles, dtype=np.int64) if tiles is None
           else np.asarray(tiles, np.int64))

    gather = np.empty((lat.q, len(sel), n), dtype=np.int32)
    bounce_links = cross_links = interior_links = fluid_nodes = 0
    for c0 in range(0, len(sel), _CHUNK_TILES):
        tl = sel[c0:c0 + _CHUNK_TILES]
        coords = (tiling.tile_coords[tl].astype(np.int64)[:, None, :] * a
                  + local[None])                                # (C, n, 3)
        fluid = tiling.node_types[tl] != SOLID
        fluid_nodes += int(fluid.sum())
        self_tile = tl[:, None]
        for q in range(lat.q):
            src = coords - lat.e[q].astype(np.int64)
            oob = np.zeros(src.shape[:2], dtype=bool)
            for ax in range(3):
                if periodic[ax]:
                    src[..., ax] %= wrap_dims[ax]
                else:
                    oob |= (src[..., ax] < 0) | (src[..., ax] >= dims[ax])
            src_cl = np.clip(src, 0, dims - 1)
            st = src_cl // a
            so = src_cl - st * a
            src_tile = tiling.tile_map[st[..., 0], st[..., 1],
                                       st[..., 2]].astype(np.int64)
            src_off = so[..., 0] + a * so[..., 1] + a * a * so[..., 2]
            src_tile_cl = np.maximum(src_tile, 0)
            solid_src = tiling.node_types[src_tile_cl,
                                          node_perm[src_off]] == SOLID
            bounce = oob | (src_tile < 0) | solid_src

            opp = int(lat.opp[q])
            idx_pull = q * m + src_tile_cl * n + eff_perms[q][src_off]
            idx_self = opp * m + self_tile * n + slot_perms[opp][None, :]
            gather[q, c0:c0 + len(tl)] = np.where(bounce, idx_self, idx_pull)

            if q > 0:
                moving = ~bounce & fluid
                same = src_tile_cl == self_tile
                bounce_links += int((bounce & fluid).sum())
                cross_links += int((moving & ~same).sum())
                interior_links += int((moving & same).sum())

    total_links = max(1, fluid_nodes * (lat.q - 1))
    return StreamTables(
        gather_idx=gather,
        perms=slot_perms.astype(np.int32),
        inv_perms=inv_perms.astype(np.int32),
        bounce_frac=bounce_links / total_links,
        cross_tile_frac=cross_links / total_links,
        interior_frac=interior_links / total_links,
        frontier_frac=cross_links / total_links,
    )
