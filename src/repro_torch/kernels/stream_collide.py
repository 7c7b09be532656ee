"""Fused stream+collide kernel (K1), its plain PyTorch version and its host
tables.

``stream_collide_tiles`` is one LBM step (the paper's Algorithm 2) over the
packed state ``f`` (T+1, Q, n): one contiguous (Q, n) data block per tile
and an all-SOLID, all-zero scratch tile at index T that empty and
out-of-grid neighbours point at, so half-way bounce-back is the ordinary
"source is solid" test.  On a CUDA tensor it launches the hand-written
kernel ``csrc/stream_collide.cu``; on a CPU tensor it runs
:func:`stream_collide_tiles_ref`.

The host tables (:func:`_pull_geometry`, :func:`build_neighbor_table`,
:func:`packed_gather_indices`) are numpy copies of the reference's
``repro.kernels.stream_collide`` helpers and hold the same bytes.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..core import collision as col
from ..core.lattice import Lattice
from ..core.tiling import (NEIGHBOR_OFFSETS, SOLID, Tiling,
                           neighbor_offset_index, node_order_permutation)
from ..roofline import count
from . import build
from .collide import collide_block_ref, collision_args

MODES = ("full", "propagation_only", "rw_only")


@lru_cache(maxsize=None)
def _pull_geometry(lat: Lattice, a: int = 4, node_order: str = "canonical"):
    """Static pull tables.

    Returns (offsets, perms (Q, n) int32, cases (Q, n) int8) where offsets
    is the ordered list of distinct neighbour tile offsets the lattice links
    to, and cases[q, node] = 0 for an in-tile source or 1 +
    offsets.index(source-tile offset).  Under a non-canonical ``node_order``
    both tables are remapped into the within-tile slot enumeration: row
    index = dst slot, perm values = src slots.
    """
    n = a ** 3
    idx = np.arange(n)
    x, y, z = idx % a, (idx // a) % a, idx // (a * a)
    offsets: list[tuple[int, int, int]] = []
    perms = np.zeros((lat.q, n), np.int32)
    cases = np.zeros((lat.q, n), np.int8)
    for q in range(lat.q):
        e = lat.e[q]
        sx, sy, sz = x - e[0], y - e[1], z - e[2]
        perms[q] = (sx % a) + a * (sy % a) + a * a * (sz % a)
        dx, dy, dz = sx // a, sy // a, sz // a       # each in {-1, 0}
        for node in range(n):
            off = (int(dx[node]), int(dy[node]), int(dz[node]))
            if off == (0, 0, 0):
                continue
            if off not in offsets:
                offsets.append(off)
            cases[q, node] = 1 + offsets.index(off)
    if node_order != "canonical":
        sigma = node_order_permutation(node_order, a)   # canonical -> slot
        inv = np.argsort(sigma, kind="stable")          # slot -> canonical
        perms = sigma[perms][:, inv].astype(np.int32)
        cases = cases[:, inv]
    return offsets, perms, cases


@lru_cache(maxsize=None)
def pull_slots(lat: Lattice, a: int = 4,
               node_order: str = "canonical") -> np.ndarray:
    """(Q, n) int8: the neighbour-table column (0..26; 13 = the tile itself)
    that holds each pull source, so the kernel never sees the offset
    list."""
    offsets, _, cases = _pull_geometry(lat, a, node_order)
    cols = np.array([neighbor_offset_index(0, 0, 0)]
                    + [neighbor_offset_index(*o) for o in offsets], np.int8)
    return cols[cases]


def build_neighbor_table(
    tiling: Tiling, periodic: tuple[bool, bool, bool] = (False, False, False)
) -> np.ndarray:
    """Kernel-ready (T, 27) neighbour table: scratch index T for empty or
    out-of-grid neighbours, periodic axes wrapped through the tile grid.

    Periodic wrap happens at tile granularity, so a periodic axis needs its
    ORIGINAL extent to be a multiple of the tile edge ``a``.
    """
    for ax in range(3):
        if periodic[ax] and tiling.orig_shape[ax] % tiling.a:
            raise ValueError(
                f"fused kernel: periodic axis {ax} needs extent % a == 0 "
                f"(got {tiling.orig_shape[ax]} % {tiling.a})")
    t = tiling.num_tiles
    grid = np.array(tiling.tile_grid, np.int64)
    shifted = (tiling.tile_coords[:, None, :].astype(np.int64)
               + NEIGHBOR_OFFSETS[None, :, :])                  # (T, 27, 3)
    in_grid = np.ones(shifted.shape[:2], bool)
    for ax in range(3):
        if periodic[ax]:
            shifted[..., ax] %= grid[ax]
        else:
            in_grid &= (shifted[..., ax] >= 0) & (shifted[..., ax] < grid[ax])
    clamped = np.clip(shifted, 0, grid - 1)
    nbr = tiling.tile_map[clamped[..., 0], clamped[..., 1], clamped[..., 2]]
    nbr = np.where(in_grid, nbr, -1)
    return np.where(nbr < 0, t, nbr).astype(np.int32)


def packed_gather_indices(gather_idx: np.ndarray, q: int, t: int,
                          n: int) -> np.ndarray:
    """Remap streaming gather indices (flat ``q*(t*n) + tile*n + off``) into
    the packed (T+1, Q, n) flat space ``tile*(q*n) + q*n + off``.  Only
    valid for ``layout_scheme='xyz'``."""
    g = gather_idx.astype(np.int64)
    qq, rem = np.divmod(g, t * n)
    tile, off = np.divmod(rem, n)
    return (tile * (q * n) + qq * n + off).astype(np.int32)


@lru_cache(maxsize=None)
def _device_tables(lat: Lattice, a: int, node_order: str, device: torch.device):
    """(perms int32, slots int8), both (Q, n), on ``device``."""
    _, perms, _ = _pull_geometry(lat, a, node_order)
    return (torch.as_tensor(perms, device=device),
            torch.as_tensor(pull_slots(lat, a, node_order), device=device))


def stream_collide_tiles_ref(f, node_types, neighbors, lat: Lattice,
                             cfg: col.CollisionConfig, a: int = 4, force=None,
                             mode: str = "full",
                             node_order: str = "canonical") -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_collide_tiles`."""
    t1, q, n = f.shape
    t = t1 - 1
    out = torch.zeros_like(f)
    if mode == "rw_only":
        out[:t] = f[:t]
        return out
    perms, slots = _device_tables(lat, a, node_order, f.device)
    perms, slots = perms.long(), slots.long()
    src_tile = neighbors.long()[:, slots]                       # (T, Q, n)
    src_node = perms.expand(t, q, n)
    qs = torch.arange(q, device=f.device)[None, :, None]
    bounce = node_types[src_tile, src_node] == SOLID
    own_opp = f[:t][:, torch.as_tensor(lat.opp, device=f.device).long()]
    f_in = torch.where(bounce, own_opp, f[src_tile, qs, src_node])
    f_in[:, 0] = f[:t, 0]
    if mode == "propagation_only":
        out[:t] = f_in
        return out
    solid = node_types[:t] == SOLID
    out[:t] = torch.stack(
        collide_block_ref(list(f_in.unbind(1)), solid, lat, cfg, force), dim=1)
    return out


def stream_collide_cost(tiles: int, lat: Lattice, cfg: col.CollisionConfig,
                        itemsize: int, n: int = 64, mode: str = "full") -> tuple[float, float]:
    """(FLOPs, bytes) of one K1 launch over ``tiles`` tiles of ``n`` nodes:
    each tile's Q n values read and written once, its node types (uint8,
    and the scratch row's) and (27,) int32 neighbour row read, the static
    (Q, n) int32 perm and int8 slot tables read once; the collision of every
    slot in ``full`` mode (``model_flops_per_node``).  ``rw_only`` moves the
    values only."""
    values = 2 * tiles * lat.q * n * itemsize
    if mode == "rw_only":
        return 0.0, float(values)
    flops = tiles * n * col.model_flops_per_node(cfg, lat) if mode == "full" else 0
    return float(flops), float(values + (tiles + 1) * n + tiles * 27 * 4 + lat.q * n * 5)


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("stream_collide")
    lib.repro_stream_collide_tiles.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_double] * 4
        + [ctypes.c_void_p])
    lib.repro_stream_collide_tiles.restype = ctypes.c_int
    return lib


def stream_collide_tiles(f, node_types, neighbors, lat: Lattice,
                         cfg: col.CollisionConfig, a: int = 4, force=None,
                         mode: str = "full", node_order: str = "canonical",
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused LBM step over all tiles.

    f:          (T+1, Q, n) — scratch tile at index T must be zero
    node_types: (T+1, n) uint8 — scratch tile must be SOLID
    neighbors:  (T, 27) int32 — empty/out-of-grid entries = T (scratch)
    mode:       'full' | 'propagation_only' | 'rw_only' (paper §4.1)
    node_order: within-tile node enumeration of f/node_types
    out:        optional (T+1, Q, n) destination whose row T is zero; the
                step never writes row T, so a caller that ping-pongs two
                such buffers keeps both scratch rows zero.  Allocated when
                not given.
    Returns the post-step (T+1, Q, n) state, scratch row zero.  On the
    meta device: the output's shape only, :func:`stream_collide_cost`
    reported to the active counter (``roofline.count``).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if f.device.type == "cpu":
        res = stream_collide_tiles_ref(f, node_types, neighbors, lat, cfg, a,
                                       force, mode, node_order)
        return res if out is None else out.copy_(res)
    t1, q, n = f.shape
    if q != lat.q or n != a ** 3:
        raise ValueError(f"f must be (T+1, Q={lat.q}, n={a ** 3}), got {tuple(f.shape)}")
    if f.dtype not in build.LBM_DTYPES:
        raise TypeError(f"stream_collide_tiles takes float32/float64, got {f.dtype}")
    if n < 8 or 256 % n:
        raise ValueError(f"the kernel takes tiles of 8, 64 or 256 nodes, got {n}")
    dev = f.device
    build.check_tensor(f, "f", dev)
    build.check_tensor(node_types, "node_types", dev, torch.uint8, (t1, n))
    build.check_tensor(neighbors, "neighbors", dev, torch.int32, (t1 - 1, 27))
    if out is None:
        out = torch.empty_like(f)
        out[t1 - 1].zero_()
    build.check_tensor(out, "out", dev, f.dtype, f.shape)
    if dev.type != "meta" and out.data_ptr() == f.data_ptr():
        raise ValueError("out must not alias f")
    cost = stream_collide_cost(t1 - 1, lat, cfg, f.element_size(), n, mode)
    if dev.type == "meta":
        count.kernel("stream_collide_tiles", *cost)
        return out
    perms, slots = _device_tables(lat, a, node_order, dev)
    if mode == "full":
        a_mat, args = collision_args(lat, cfg, force, f)
    else:
        a_mat, args = None, (0, 0, 0, 1.0, 0.0, 0.0, 0.0)
    lib = _lib()
    # the launch function launches into, and sets attributes on, the
    # current card: make it the tensor's, which may be another card
    with torch.cuda.device(dev):
        code = lib.repro_stream_collide_tiles(
            *(build.ptr(x) for x in (f, node_types, neighbors, perms, slots,
                                     a_mat, out)),
            t1 - 1, q, n, build.DTYPE_CODES[f.dtype], MODES.index(mode), *args,
            build.stream(dev))
    build.check(lib, code, "stream_collide_tiles")
    stream_collide_tiles.launches += 1
    count.kernel("stream_collide_tiles", *cost)
    return out


stream_collide_tiles.launches = 0
