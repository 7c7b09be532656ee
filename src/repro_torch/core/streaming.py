"""Streaming (propagation) index builder for the sparse tiled engine (numpy).

The port's copy of ``repro.core.streaming``.  For every (direction, tile,
node) the host precomputes the flat index of the pull source, folding in
the per-direction data-block layout, the within-tile node enumeration,
cross-tile links through the tile map, half-way bounce-back at solid nodes
and optional periodic axes.  Two runtime representations are built:

* **monolithic** (``gather_idx``): one (Q, T, n) int32 table; streaming is
  ONE gather per direction from the flattened (Q * T * a^3) state.
* **split-phase** (``split=True`` -> :class:`SplitStreamTables`): interior
  links are a single (Q, n) permutation broadcast over tiles, regular
  cross-tile links are computed from the (T, 27) neighbour table and the
  same (Q, n) tables, only bounce links carry a per-link entry (a flat
  destination list), plus explicit (dst, src) pairs for the rare links the
  static prediction cannot express (periodic wrap on an extent that is not
  a multiple of the tile edge).  The lists are derived by comparing the
  static prediction against ``gather_idx``, so the two paths agree at
  fluid nodes by construction.

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
from .tiling import (NEIGHBOR_OFFSETS, SOLID, Tiling, neighbor_offset_index,
                     pow2_hist)

_CHUNK_TILES = 4096
SELF_OFFSET = neighbor_offset_index(0, 0, 0)          # 13


@dataclasses.dataclass
class SplitStreamTables:
    """Compact split-phase streaming tables (numpy; shipped to device).

    Destination indices live in the flat canonical (Q*T*n) space
    ``q*m + t*n + s``; source indices in the per-direction storage space
    (the space the monolithic ``gather_idx`` values use).
    """

    intra_idx: np.ndarray      # (Q, n) int32 wrapped source storage offset
    case: np.ndarray           # (Q, n) int8  27-neighbour offset idx (13=self)
    is_cross: np.ndarray       # (Q, n) bool  case != 13
    nbr: np.ndarray            # (T, 27) int32 neighbour tile (absent -> self)
    bounce_dst: np.ndarray     # (Lb,) int32 flat canonical destinations
    irregular_dst: np.ndarray  # (Li,) int32 flat canonical destinations
    irregular_src: np.ndarray  # (Li,) int32 flat storage sources
    opp: np.ndarray            # (Q,) int32 opposite-direction map

    @property
    def index_entries(self) -> int:
        """Stored index-table entries: (Q*n intra + Q*n case + 27*T nbr
        + bounce dst + irregular pairs).  Compare with Q*T*n monolithic."""
        return (self.intra_idx.size + self.case.size + self.nbr.size
                + self.bounce_dst.size + self.irregular_dst.size
                + self.irregular_src.size + self.opp.size)

    @property
    def index_bytes(self) -> int:
        return (self.intra_idx.nbytes + self.case.nbytes + self.nbr.nbytes
                + self.bounce_dst.nbytes + self.irregular_dst.nbytes
                + self.irregular_src.nbytes + self.opp.nbytes)


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
    # locality of the cross-tile links in tile-index space: how far apart
    # in the storage order the two ends of a cross-tile link sit, which the
    # tile traversal policy (Tiling.order) reshapes
    mean_link_distance: float = 0.0
    link_distance_hist: dict = dataclasses.field(default_factory=dict)
    split: SplitStreamTables | None = None

    @property
    def index_entries_mono(self) -> int:
        return int(self.gather_idx.size)

    @property
    def index_bytes_mono(self) -> int:
        return int(self.gather_idx.nbytes)


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
    split: bool = False,
) -> StreamTables:
    """Pull-streaming gather rows for ``tiles`` (default: every tile), and
    with ``split`` the split-phase tables (every tile only)."""
    if split and tiles is not None:
        raise ValueError("split tables cover every tile; tiles= must be None")
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
    bounce_all = np.empty((lat.q, len(sel), n), dtype=bool) if split else None
    bounce_links = cross_links = interior_links = fluid_nodes = dist_sum = 0
    dist_buckets = np.zeros(64, dtype=np.int64)
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
            if split:
                bounce_all[q, c0:c0 + len(tl)] = bounce

            if q > 0:
                moving = ~bounce & fluid
                same = src_tile_cl == self_tile
                bounce_links += int((bounce & fluid).sum())
                cross = moving & ~same
                cross_links += int(cross.sum())
                interior_links += int((moving & same).sum())
                if cross.any():
                    d = np.abs(src_tile_cl - self_tile)[cross]
                    dist_sum += int(d.sum())
                    dist_buckets += np.bincount(np.floor(np.log2(d)).astype(int),
                                                minlength=64)[:64]

    total_links = max(1, fluid_nodes * (lat.q - 1))
    tables = StreamTables(
        gather_idx=gather,
        perms=slot_perms.astype(np.int32),
        inv_perms=inv_perms.astype(np.int32),
        bounce_frac=bounce_links / total_links,
        cross_tile_frac=cross_links / total_links,
        interior_frac=interior_links / total_links,
        frontier_frac=cross_links / total_links,
        mean_link_distance=dist_sum / cross_links if cross_links else 0.0,
        link_distance_hist=pow2_hist(dist_buckets),
    )
    if split:
        tables.split = _build_split_tables(tiling, lat, periodic, eff_perms,
                                           gather, bounce_all,
                                           tiling.node_types != SOLID)
    return tables


def _split_neighbor_table(tiling: Tiling,
                          periodic: tuple[bool, bool, bool]) -> np.ndarray:
    """(T, 27) neighbour tile ids for the split-phase cross gather.

    Absent / out-of-grid neighbours point at the tile ITSELF (every such
    link is a bounce link, overwritten by the bounce scatter).  Periodic
    axes wrap at tile granularity when the original extent is a multiple
    of ``a``; otherwise the wrap-crossing links land in the irregular list.
    """
    grid = np.array(tiling.tile_grid, np.int64)
    shifted = (tiling.tile_coords[:, None, :].astype(np.int64)
               + NEIGHBOR_OFFSETS[None, :, :])                  # (T, 27, 3)
    in_grid = np.ones(shifted.shape[:2], bool)
    for ax in range(3):
        if periodic[ax] and tiling.orig_shape[ax] % tiling.a == 0:
            shifted[..., ax] %= grid[ax]
        else:
            in_grid &= (shifted[..., ax] >= 0) & (shifted[..., ax] < grid[ax])
    clamped = np.clip(shifted, 0, grid - 1)
    nbr = tiling.tile_map[clamped[..., 0], clamped[..., 1], clamped[..., 2]]
    nbr = np.where(in_grid, nbr, -1).astype(np.int64)
    own = np.arange(tiling.num_tiles, dtype=np.int64)[:, None]
    return np.where(nbr < 0, own, nbr).astype(np.int32)


def _build_split_tables(tiling: Tiling, lat: Lattice, periodic,
                        eff_perms: np.ndarray, gather: np.ndarray,
                        bounce: np.ndarray, fluid: np.ndarray
                        ) -> SplitStreamTables:
    """Factor ``gather`` into the compact split-phase representation:
    positions where the static prediction (intra permutation broadcast +
    neighbour-table cross links) disagrees with the monolithic table at
    fluid destinations become per-link entries (bounce destinations, or
    explicit irregular pairs)."""
    a, n, t_cnt, q_cnt = tiling.a, tiling.nodes_per_tile, tiling.num_tiles, lat.q
    m = t_cnt * n
    c = tiling.node_of_slot                              # slot -> canonical
    x, y, z = c % a, (c // a) % a, c // (a * a)          # coords per slot

    intra = np.zeros((q_cnt, n), np.int64)
    case = np.full((q_cnt, n), SELF_OFFSET, np.int64)
    for q in range(q_cnt):
        e = lat.e[q].astype(np.int64)
        sx, sy, sz = x - e[0], y - e[1], z - e[2]
        wrapped = (sx % a) + a * (sy % a) + a * a * (sz % a)   # canonical
        intra[q] = eff_perms[q][wrapped]
        case[q] = SELF_OFFSET + (sx // a) + 3 * (sy // a) + 9 * (sz // a)

    nbr = _split_neighbor_table(tiling, periodic)        # (T, 27)
    src_tile = nbr[:, case]                              # (T, Q, n)
    static = (np.arange(q_cnt, dtype=np.int64)[None, :, None] * m
              + src_tile.astype(np.int64) * n + intra[None, :, :])
    static = np.moveaxis(static, 0, 1)                   # (Q, T, n)

    mismatch = (static != gather) & fluid[None]
    b_dst = np.nonzero((mismatch & bounce).reshape(-1))[0]
    irr = np.nonzero((mismatch & ~bounce).reshape(-1))[0]
    return SplitStreamTables(
        intra_idx=intra.astype(np.int32),
        case=case.astype(np.int8),
        is_cross=case != SELF_OFFSET,
        nbr=nbr.astype(np.int32),
        bounce_dst=b_dst.astype(np.int32),
        irregular_dst=irr.astype(np.int32),
        irregular_src=gather.reshape(-1)[irr].astype(np.int32),
        opp=lat.opp.astype(np.int32),
    )
