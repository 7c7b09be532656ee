"""Host-side geometry tiler — Algorithm 1 of the paper (numpy).

A copy of the parts of ``repro.core.tiling`` the port's solver needs, kept
here so that the port never imports the JAX package.  The geometry (a dense
uint8 node-type array) is covered by a uniform mesh of cubic tiles of
``a**3`` nodes starting at node (0,0,0); tiles containing only solid nodes
are dropped.  Products (paper Fig. 2):

* ``tile_coords``  — (T, 3) tile-grid coordinates of every non-empty tile,
  in the requested :data:`TILE_ORDERS` traversal.
* ``tile_map``     — dense (TX, TY, TZ) int32 matrix: tile index or -1.
* ``tile_neighbors`` — (T, 27) int32 neighbour tile index or -1.
* ``node_types``   — (T, a^3) uint8 node types, node axis in ``node_order``
  slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# node types
SOLID = 0
FLUID = 1
INLET = 2    # Zou-He velocity inlet
OUTLET = 3   # constant-pressure outlet

NEIGHBOR_OFFSETS = np.array(
    [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    dtype=np.int32,
)  # (27, 3); offset (0,0,0) is index 13


def neighbor_offset_index(dx: int, dy: int, dz: int) -> int:
    return (dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)


# tile traversal orders: "zmajor" sorts by (z, y, x); "morton" is the 3-D
# Z-curve; "hilbert" the 3-D Hilbert curve (Skilling); "morton_slab" is
# Morton within each z tile-layer, z layers contiguous.
TILE_ORDERS = ("zmajor", "morton", "hilbert", "morton_slab")
# orderings that keep runs of z tile-layers contiguous (dist.lbm.SlabPlan)
SLAB_COMPATIBLE_ORDERS = ("zmajor", "morton_slab")

# within-tile node orders: "canonical" x + a*y + a^2*z; "sfc" the 3-D Morton
# order of the local coordinates; "frontier_last" tile-face nodes form a
# contiguous suffix.  Every order is one (a^3,) permutation shared by all
# tiles.
NODE_ORDERS = ("canonical", "sfc", "frontier_last")


def _spread_bits(v: np.ndarray, bits: int, stride: int) -> np.ndarray:
    """Insert ``stride - 1`` zero bits between the low ``bits`` bits of v."""
    v = v.astype(np.uint64)
    out = np.zeros_like(v)
    one = np.uint64(1)
    for b in range(bits):
        out |= ((v >> np.uint64(b)) & one) << np.uint64(stride * b)
    return out


def morton_key_3d(x, y, z, bits: int) -> np.ndarray:
    """Z-curve key: bit b of x/y/z lands at position 3b / 3b+1 / 3b+2."""
    return (_spread_bits(x, bits, 3)
            | (_spread_bits(y, bits, 3) << np.uint64(1))
            | (_spread_bits(z, bits, 3) << np.uint64(2)))


def morton_key_2d(x, y, bits: int) -> np.ndarray:
    return _spread_bits(x, bits, 2) | (_spread_bits(y, bits, 2) << np.uint64(1))


def hilbert_key_3d(coords: np.ndarray, bits: int) -> np.ndarray:
    """3-D Hilbert-curve distance of integer points (vectorised).

    Skilling's AxesToTranspose (J. Skilling, "Programming the Hilbert
    curve", 2004) followed by an MSB-first bit interleave of the transposed
    axes.
    """
    one = np.uint64(1)
    x = [coords[:, i].astype(np.uint64) for i in range(3)]
    q = one << np.uint64(bits - 1)
    while q > one:
        p = q - one
        for i in range(3):
            hi = (x[i] & q) != 0
            if i == 0:
                x[0] = np.where(hi, x[0] ^ p, x[0])
            else:
                t = (x[0] ^ x[i]) & p
                x[0] = np.where(hi, x[0] ^ p, x[0] ^ t)
                x[i] = np.where(hi, x[i], x[i] ^ t)
        q >>= one
    for i in range(1, 3):
        x[i] ^= x[i - 1]
    t = np.zeros_like(x[0])
    q = one << np.uint64(bits - 1)
    while q > one:
        t = np.where((x[2] & q) != 0, t ^ (q - one), t)
        q >>= one
    for i in range(3):
        x[i] ^= t
    key = np.zeros_like(x[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << one) | ((x[i] >> np.uint64(b)) & one)
    return key


def pow2_hist(counts: np.ndarray) -> dict:
    """Per-log2-bucket counts as ``{"1": n, "2-3": n, "4-7": n}``
    (JSON-friendly; bucket k covers distances in [2^k, 2^(k+1)))."""
    out = {}
    for k, c in enumerate(counts):
        if not c:
            continue
        lo, hi = 2 ** k, 2 ** (k + 1) - 1
        out[str(lo) if lo == hi else f"{lo}-{hi}"] = int(c)
    return out


def tile_order_permutation(coords: np.ndarray, order: str) -> np.ndarray:
    """Permutation taking z-major-sorted tile coords into ``order``."""
    if order == "zmajor":
        return np.arange(len(coords), dtype=np.int64)
    if order not in TILE_ORDERS:
        raise ValueError(
            f"unknown tile order {order!r}; expected one of {TILE_ORDERS}")
    x = coords[:, 0].astype(np.uint64)
    y = coords[:, 1].astype(np.uint64)
    z = coords[:, 2].astype(np.uint64)
    bits = max(1, int(coords.max(initial=0)).bit_length())
    if order == "morton":
        return np.argsort(morton_key_3d(x, y, z, bits), kind="stable")
    if order == "hilbert":
        return np.argsort(hilbert_key_3d(coords, bits), kind="stable")
    return np.lexsort((morton_key_2d(x, y, bits), z))


def static_frontier_mask(a: int) -> np.ndarray:
    """(a^3,) bool over CANONICAL offsets: True where the node touches a
    tile face."""
    n = np.arange(a ** 3)
    x, y, z = n % a, (n // a) % a, n // (a * a)
    edge = a - 1
    return (x == 0) | (x == edge) | (y == 0) | (y == edge) \
        | (z == 0) | (z == edge)


def node_order_permutation(order: str, a: int) -> np.ndarray:
    """sigma: canonical offset -> storage slot, for ``order`` (NODE_ORDERS)."""
    n = a ** 3
    if order == "canonical":
        return np.arange(n, dtype=np.int64)
    if order not in NODE_ORDERS:
        raise ValueError(
            f"unknown node order {order!r}; expected one of {NODE_ORDERS}")
    idx = np.arange(n)
    x, y, z = idx % a, (idx // a) % a, idx // (a * a)
    if order == "sfc":
        bits = max(1, (a - 1).bit_length())
        node_of_slot = np.argsort(
            morton_key_3d(x.astype(np.uint64), y.astype(np.uint64),
                          z.astype(np.uint64), bits), kind="stable")
    else:  # frontier_last: (is_face_node, canonical) lexicographic
        node_of_slot = np.argsort(
            static_frontier_mask(a).astype(np.int64) * n + idx, kind="stable")
    sigma = np.empty(n, dtype=np.int64)
    sigma[node_of_slot] = np.arange(n, dtype=np.int64)
    return sigma


@dataclasses.dataclass
class Tiling:
    a: int                       # nodes per tile edge
    shape: tuple[int, int, int]  # padded geometry shape (multiples of a)
    orig_shape: tuple[int, int, int]
    tile_grid: tuple[int, int, int]
    tile_coords: np.ndarray      # (T, 3) int32, tile-grid coords (nonEmptyTiles)
    tile_map: np.ndarray         # (TX, TY, TZ) int32
    tile_neighbors: np.ndarray   # (T, 27) int32
    node_types: np.ndarray       # (T, a^3) uint8, node axis in node_order slots
    order: str = "zmajor"
    node_order: str = "canonical"

    @property
    def node_perm(self) -> np.ndarray:
        """sigma: canonical XYZ offset -> storage slot (a^3,)."""
        return node_order_permutation(self.node_order, self.a)

    @property
    def node_of_slot(self) -> np.ndarray:
        """Inverse of :attr:`node_perm`: storage slot -> canonical offset."""
        return np.argsort(self.node_perm, kind="stable")

    @property
    def num_tiles(self) -> int:
        return len(self.tile_coords)

    @property
    def nodes_per_tile(self) -> int:
        return self.a ** 3

    @property
    def n_fluid_nodes(self) -> int:
        """Non-solid nodes over the whole geometry (n_fn)."""
        return int((self.node_types != SOLID).sum())

    @property
    def tile_utilisation(self) -> float:
        """Average tile utilisation eta_t = n_fn / (t_n * n_tn)  (Eqn 14)."""
        denom = self.num_tiles * self.nodes_per_tile
        return self.n_fluid_nodes / denom if denom else 0.0

    @property
    def porosity(self) -> float:
        """Non-solid nodes / bounding-box nodes (paper §4.6 definition)."""
        return self.n_fluid_nodes / float(np.prod(self.orig_shape))

    def overhead_generic(self) -> float:
        """Delta_eta (Eqn 15): extra work ratio from solid nodes in tiles."""
        eta = self.tile_utilisation
        return (1.0 - eta) / eta if eta > 0 else float("inf")

    def overhead_memory(self, q: int = 19, n_d: int = 8, n_t: int = 1) -> float:
        """Delta^M_eta (Eqn 16) vs the q*n_d minimum of Eqn (9)."""
        eta = self.tile_utilisation
        if eta == 0:
            return float("inf")
        return (2.0 * q * n_d + n_t) / (eta * q * n_d) - 1.0

    # ---- locality diagnostics (the data-placement half of the paper) ----
    def neighbor_index_distances(self) -> np.ndarray:
        """|neighbour tile index - own index| over every populated
        neighbour-table link (self offset excluded): small distances mean
        linked tiles sit close in the storage order that ``order`` sets."""
        own = np.arange(self.num_tiles, dtype=np.int64)[:, None]
        nbr = self.tile_neighbors.astype(np.int64)
        valid = nbr >= 0
        valid[:, neighbor_offset_index(0, 0, 0)] = False
        return np.abs(nbr - own)[valid]

    def mean_neighbor_index_distance(self) -> float:
        d = self.neighbor_index_distances()
        return float(d.mean()) if d.size else 0.0

    def neighbor_index_distance_hist(self) -> dict:
        """Power-of-two histogram of the neighbour index distances
        (:func:`pow2_hist`)."""
        d = self.neighbor_index_distances()
        if not d.size:
            return {}
        buckets = np.floor(np.log2(np.maximum(d, 1))).astype(int)
        return pow2_hist(np.bincount(buckets))

    def locality_metrics(self) -> dict:
        """JSON-ready placement summary (the reference's geometry suite)."""
        return {
            "tile_order": self.order,
            "mean_neighbor_index_distance": round(self.mean_neighbor_index_distance(), 2),
            "neighbor_index_distance_hist": self.neighbor_index_distance_hist(),
        }

    def intra_tile_link_distances(self, e: np.ndarray | None = None) -> np.ndarray:
        """|src slot - dst slot| over every statically intra-tile link: for
        each moving direction whose pull source stays inside the tile, the
        distance between the link's two ends in the storage slot order,
        which ``node_order`` reshapes (the tile order does not).  Every tile
        shares the one (a^3,) slot permutation, so this is one pass.

        ``e``: (Q, 3) velocity set; default the 26-point unit stencil."""
        a = self.a
        if e is None:
            e = NEIGHBOR_OFFSETS
        sigma = self.node_perm                       # canonical -> slot
        c = self.node_of_slot                        # slot -> canonical
        x, y, z = c % a, (c // a) % a, c // (a * a)  # coords per slot
        slots = np.arange(a ** 3, dtype=np.int64)
        out = []
        for eq in np.asarray(e, np.int64):
            if not eq.any():
                continue
            sx, sy, sz = x - eq[0], y - eq[1], z - eq[2]
            intra = ((sx >= 0) & (sx < a) & (sy >= 0) & (sy < a)
                     & (sz >= 0) & (sz < a))
            src = sigma[(sx + a * sy + a * a * sz)[intra]]
            out.append(np.abs(src - slots[intra]))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)

    def mean_intra_tile_link_distance(self, e: np.ndarray | None = None) -> float:
        """Mean storage-slot distance of the intra-tile links."""
        d = self.intra_tile_link_distances(e)
        return float(d.mean()) if d.size else 0.0

    def node_coords(self) -> np.ndarray:
        """Global (x, y, z) for every (tile, node) slot — (T, a^3, 3) int32."""
        a = self.a
        n = self.node_of_slot.astype(np.int32)
        local = np.stack([n % a, (n // a) % a, n // (a * a)], axis=-1)
        return self.tile_coords[:, None, :] * a + local[None, :, :]


def tile_geometry(node_type: np.ndarray, a: int = 4,
                  order: str = "zmajor",
                  node_order: str = "canonical") -> Tiling:
    """Cover ``node_type`` (X, Y, Z) with a^3 tiles, dropping all-solid tiles.

    The paper's Algorithm 1, vectorised.  Geometry is padded with SOLID up to
    multiples of ``a``.
    """
    assert node_type.ndim == 3, "node_type must be (Nx, Ny, Nz)"
    node_type = np.ascontiguousarray(node_type.astype(np.uint8))
    orig_shape = node_type.shape
    pad = [(0, (-s) % a) for s in orig_shape]
    if any(p[1] for p in pad):
        node_type = np.pad(node_type, pad, constant_values=SOLID)
    nx, ny, nz = node_type.shape
    tx, ty, tz = nx // a, ny // a, nz // a

    # (tx, a, ty, a, tz, a) -> (tx, ty, tz, a^3) in XYZ node order (x fastest)
    blocks = node_type.reshape(tx, a, ty, a, tz, a)
    blocks = blocks.transpose(0, 2, 4, 5, 3, 1)
    blocks = blocks.reshape(tx, ty, tz, a ** 3)

    non_empty = (blocks != SOLID).any(axis=-1)

    coords = np.argwhere(non_empty.transpose(2, 1, 0))  # (T, [z, y, x])
    coords = coords[:, ::-1].astype(np.int32)           # (T, [x, y, z])
    coords = np.ascontiguousarray(coords[tile_order_permutation(coords, order)])

    tile_map = np.full((tx, ty, tz), -1, dtype=np.int32)
    tile_map[coords[:, 0], coords[:, 1], coords[:, 2]] = np.arange(
        len(coords), dtype=np.int32
    )

    shifted = coords[:, None, :] + NEIGHBOR_OFFSETS[None, :, :]  # (T, 27, 3)
    in_grid = (
        (shifted >= 0).all(axis=-1)
        & (shifted[..., 0] < tx)
        & (shifted[..., 1] < ty)
        & (shifted[..., 2] < tz)
    )
    clamped = np.clip(shifted, 0, np.array([tx - 1, ty - 1, tz - 1]))
    neigh = tile_map[clamped[..., 0], clamped[..., 1], clamped[..., 2]]
    neigh = np.where(in_grid, neigh, -1).astype(np.int32)

    types = blocks[coords[:, 0], coords[:, 1], coords[:, 2]]  # (T, a^3)
    if node_order != "canonical":
        node_of_slot = np.argsort(
            node_order_permutation(node_order, a), kind="stable")
        types = types[:, node_of_slot]

    return Tiling(
        a=a,
        shape=(nx, ny, nz),
        orig_shape=tuple(orig_shape),
        tile_grid=(tx, ty, tz),
        tile_coords=coords,
        tile_map=tile_map,
        tile_neighbors=neigh,
        node_types=types.astype(np.uint8),
        order=order,
        node_order=node_order,
    )


def untile(tiling: Tiling, values: np.ndarray, fill=0.0) -> np.ndarray:
    """Scatter per-(tile, node) values back onto the dense padded grid.

    values: (..., T, a^3) -> (..., Nx, Ny, Nz)
    """
    nx, ny, nz = tiling.shape
    lead = values.shape[:-2]
    out_dtype = np.result_type(values.dtype, fill)
    out = np.full(lead + (nx, ny, nz), fill, dtype=out_dtype)
    coords = tiling.node_coords()
    out[..., coords[..., 0], coords[..., 1], coords[..., 2]] = values
    return out


def tile_field(tiling: Tiling, dense: np.ndarray) -> np.ndarray:
    """Gather a dense (..., Nx, Ny, Nz) field into (..., T, a^3) tile slots
    (the inverse of :func:`untile` on the tiles' nodes)."""
    pad_width = [(0, 0)] * (dense.ndim - 3) + [
        (0, tiling.shape[i] - dense.shape[dense.ndim - 3 + i]) for i in range(3)]
    if any(p[1] for p in pad_width):
        dense = np.pad(dense, pad_width)
    coords = tiling.node_coords()
    return dense[..., coords[..., 0], coords[..., 1], coords[..., 2]]
