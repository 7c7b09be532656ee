"""Step backends for :class:`repro_torch.core.engine.SparseTiledLBM`.

A backend owns the device-resident representation of f and advances it by
one LBM iteration:

* ``gather`` — one gather per direction from the per-direction storage
  layout (every ``layout_scheme``), then plain torch collision or, with
  ``use_kernel``, the collision kernel K2.  The plain-tensor reference path.
* ``fused``  — the paper's contribution: the fused stream+collide kernel K1
  over state kept PERSISTENTLY in the kernel's packed (T+1, Q, n) layout.
  Two such buffers ping-pong; the kernel never writes the scratch row T, so
  both keep it zero.  Open boundaries are a post-kernel pass over the tiles
  that hold boundary nodes only.

Both produce the same physics (float64 parity to 1e-12 is pinned by the
tests against the JAX package's gather engine).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.collide import collide_tiles
from ..kernels.stream_collide import (build_neighbor_table,
                                      packed_gather_indices,
                                      stream_collide_tiles)
from . import collision as col
from .boundary import apply_open_boundary
from .streaming import StreamTables, build_stream_tables
from .tiling import SOLID, Tiling

BACKENDS = ("gather", "fused")


def make_backend(name: str, cfg, lat, tiling: Tiling,
                 tables: StreamTables | None, device: torch.device):
    if name == "gather":
        return GatherBackend(cfg, lat, tiling, tables, device)
    if name == "fused":
        return FusedBackend(cfg, lat, tiling, device)
    raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")


def boundary_pass_tables(tiling: Tiling, lat, boundaries, periodic):
    """Host-side tables for the fused backend's masked NEBB pass.

    Returns numpy ``(tiles (B,), packed_gather (Q, B, n), type_masks
    (S, B, n), solid (B, n))`` restricted to the tiles that hold boundary
    nodes, or ``None`` when no node matches any declared boundary type.
    Only those B tiles' stream-table rows are built.
    """
    types = tiling.node_types
    t, n = types.shape
    node_bc = np.zeros_like(types, bool)
    for tv, _ in boundaries:
        node_bc |= types == tv
    bt = np.nonzero(node_bc.any(axis=1))[0].astype(np.int32)
    if not len(bt):
        return None
    rows = build_stream_tables(tiling, lat, "xyz", periodic, tiles=bt)
    packed = packed_gather_indices(rows.gather_idx, lat.q, t, n)
    type_masks = np.stack([types[bt] == tv for tv, _ in boundaries])
    return bt, packed, type_masks, types[bt] == SOLID


def nebb_boundary_pass(f_pre, out, lat, collision_cfg, force, specs,
                       tiles, gather, type_masks, solid):
    """The fused backend's post-kernel masked NEBB pass, in place on ``out``.

    Re-streams ONLY the boundary tiles from the pre-step packed state
    ``f_pre`` through the packed-layout ``gather``, applies the NEBB rebuild
    per boundary spec, collision and solid masking, and writes those tiles
    of ``out``.  The rebuild sees post-streaming, pre-collision values, as
    the gather backend's in-line application does.
    """
    q, n = out.shape[-2], out.shape[-1]
    f_in = torch.take(f_pre, gather).reshape(q, -1, n)     # (Q, B, n)
    for mask, spec in zip(type_masks, specs):
        f_in = apply_open_boundary(f_in, mask, spec, lat)
    f_out, _, _ = col.collide(f_in, lat, collision_cfg, force)
    f_out = f_out.masked_fill(solid[None], 0.0)
    out[tiles] = f_out.movedim(0, 1)
    return out


class GatherBackend:
    """One-gather-per-direction streaming + torch (or K2) collision."""

    name = "gather"

    def __init__(self, cfg, lat, tiling: Tiling, tables: StreamTables,
                 device: torch.device):
        self.cfg, self.lat, self.tiling = cfg, lat, tiling
        types = tiling.node_types
        self._solid = torch.as_tensor(types == SOLID, device=device)
        self._bc_masks = [(torch.as_tensor(types == tv, device=device), spec)
                          for tv, spec in cfg.boundaries]
        self._gather = torch.as_tensor(tables.gather_idx.reshape(lat.q, -1),
                                       dtype=torch.int64, device=device)
        t, n = tiling.num_tiles, tiling.nodes_per_tile
        self._perms = torch.as_tensor(tables.perms, dtype=torch.int64,
                                      device=device)[:, None, :].expand(lat.q, t, n)
        self._inv_perms = torch.as_tensor(tables.inv_perms, dtype=torch.int64,
                                          device=device)[:, None, :].expand(lat.q, t, n)

    # ------------------------------------------------- layout shuffles
    def to_storage(self, f_canon: torch.Tensor) -> torch.Tensor:
        """canonical node order -> per-direction storage layout."""
        if self.cfg.layout_scheme == "xyz":
            return f_canon
        return torch.gather(f_canon, 2, self._inv_perms)

    def canonical(self, f_store: torch.Tensor) -> torch.Tensor:
        if self.cfg.layout_scheme == "xyz":
            return f_store
        return torch.gather(f_store, 2, self._perms)

    def initial_state(self, feq_canon: torch.Tensor) -> torch.Tensor:
        return self.to_storage(feq_canon).contiguous()

    # ------------------------------------------------------------ step
    def _collide(self, f_in):
        if self.cfg.use_kernel:
            return collide_tiles(f_in, self._solid, self.lat,
                                 self.cfg.collision, force=self.cfg.force)
        f_out, _, _ = col.collide(f_in, self.lat, self.cfg.collision,
                                  self.cfg.force)
        return f_out

    def step(self, f_store: torch.Tensor) -> torch.Tensor:
        if self.cfg.kernel_mode == "rw_only":
            # paper §4.1: read + write the node's own data, no propagation
            return f_store.clone()
        # streaming + bounce-back: one gather per direction
        f_in = torch.take(f_store, self._gather).reshape(f_store.shape)
        if self.cfg.kernel_mode == "propagation_only":
            return self.to_storage(f_in)
        for mask, spec in self._bc_masks:
            f_in = apply_open_boundary(f_in, mask, spec, self.lat)
        f_out = self._collide(f_in).masked_fill(self._solid[None], 0.0)
        return self.to_storage(f_out)


class FusedBackend:
    """Persistent packed (T+1, Q, n) state + the fused kernel K1."""

    name = "fused"

    def __init__(self, cfg, lat, tiling: Tiling, device: torch.device):
        if cfg.layout_scheme != "xyz":
            raise ValueError(
                "backend='fused' keeps f in the kernel's packed tile layout; "
                f"layout_scheme must be 'xyz' (got {cfg.layout_scheme!r})")
        self.cfg, self.lat, self.tiling = cfg, lat, tiling
        t, n = tiling.num_tiles, tiling.nodes_per_tile
        types = np.full((t + 1, n), SOLID, np.uint8)
        types[:t] = tiling.node_types
        self._types = torch.as_tensor(types, device=device)
        self._nbrs = torch.as_tensor(build_neighbor_table(tiling, cfg.periodic),
                                     device=device)
        self._solid = torch.as_tensor(tiling.node_types == SOLID, device=device)
        self._bc = None
        bc_np = (boundary_pass_tables(tiling, lat, cfg.boundaries, cfg.periodic)
                 if cfg.boundaries and cfg.kernel_mode == "full" else None)
        if bc_np is not None:
            bt, packed, type_masks, solid_b = bc_np
            self._bc = {
                "tiles": torch.as_tensor(bt, dtype=torch.int64, device=device),
                "gather": torch.as_tensor(packed, dtype=torch.int64,
                                          device=device).reshape(-1),
                "type_masks": torch.as_tensor(type_masks, device=device),
                "solid": torch.as_tensor(solid_b, device=device),
                "specs": tuple(spec for _, spec in cfg.boundaries),
            }
        self._bufs: tuple[torch.Tensor, torch.Tensor] | None = None

    # ------------------------------------------------------------ state
    def initial_state(self, feq_canon: torch.Tensor) -> torch.Tensor:
        """Pack once into two zeroed buffers (scratch rows zero); returns
        the first.  The only canonical -> packed shuffle in the engine."""
        q, t, n = feq_canon.shape
        self._bufs = None                  # free the old pair first
        bufs = tuple(torch.zeros((t + 1, q, n), dtype=feq_canon.dtype,
                                 device=feq_canon.device) for _ in range(2))
        bufs[0][:t] = feq_canon.movedim(0, 1)
        self._bufs = bufs
        return bufs[0]

    def canonical(self, f_packed: torch.Tensor) -> torch.Tensor:
        """Unpack for diagnostics only — never called from step/run."""
        return f_packed[:-1].movedim(0, 1)              # (Q, T, n)

    def other(self, f: torch.Tensor) -> torch.Tensor:
        """The buffer of the pair that a step from ``f`` writes."""
        a, b = self._bufs
        return b if f.data_ptr() == a.data_ptr() else a

    # ------------------------------------------------------------ step
    def step(self, f: torch.Tensor) -> torch.Tensor:
        out = self.other(f)
        cfg = self.cfg
        stream_collide_tiles(f, self._types, self._nbrs, self.lat,
                             cfg.collision, a=cfg.a, force=cfg.force,
                             mode=cfg.kernel_mode, node_order=cfg.node_order,
                             out=out)
        if self._bc is not None:
            tab = self._bc
            nebb_boundary_pass(f, out, self.lat, cfg.collision, cfg.force,
                               tab["specs"], tab["tiles"], tab["gather"],
                               tab["type_masks"], tab["solid"])
        return out
