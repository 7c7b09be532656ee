"""Step backends for :class:`repro_torch.core.engine.SparseTiledLBM`.

A backend owns the device-resident representation of f and advances it by
one LBM iteration:

* ``gather`` — one gather per direction from the per-direction storage
  layout (every ``layout_scheme``), then plain torch collision or, with
  ``use_kernel``, the collision kernel K2.  The plain-tensor reference path.
* ``fused``  — the paper's contribution: the fused stream+collide kernel K1
  over state kept PERSISTENTLY in the kernel's packed (T+1, Q, n) layout.
  Two such buffers ping-pong; the kernel never writes the scratch row T, so
  both keep it zero.  Open boundaries are a post-kernel pass over the
  boundary nodes only (``kernels.nebb_pass``: one kernel launch a step).

Both produce the same physics (float64 parity to 1e-12 is pinned by the
tests against the JAX package's gather engine).

Ensembles (``repro_torch.sim.ensemble``): both backends advance B
independent flow states over the SAME geometry, loading the index tables
once per step for all B:

* gather — f carries a leading batch axis (B, Q, T, n); one gather (or one
  split-phase pass) streams every replica, then each replica is relaxed by
  the single engine's own functions on its contiguous (Q, T, n) slice, so
  every replica stays bitwise equal to an independent engine.
* fused — the packed tile axis is replicated, (B*T + 1, Q, n): per-replica
  offsets folded into the neighbour table, one shared zero scratch row at
  B*T, so ONE launch of K1 over B*T tiles advances every replica.  The
  ensemble owns its own pair of such buffers; the engine's pair is never
  touched.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..kernels.collide import collide_tiles
from ..kernels.nebb_pass import BoundaryNodes, nebb_boundary_pass
from ..kernels.stream_collide import (build_neighbor_table,
                                      packed_gather_indices,
                                      stream_collide_tiles)
from ..obs.trace import phase_scope
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


def boundary_pass_tables(tiling: Tiling, lat, boundaries,
                         periodic) -> BoundaryNodes | None:
    """Host-side tables of the fused backend's NEBB pass: every node of a
    declared boundary type once, in tile and slot order, with its spec
    index and its Q pull sources (numpy :class:`BoundaryNodes`), or ``None``
    when no node matches any declared boundary type.

    The sources are the rows of the packed gather (``packed_gather_indices``
    of the stream tables, which fold in bounce-back and periodic edges) at
    those nodes; only the tiles that hold them get stream-table rows.
    """
    types = tiling.node_types
    t, n = types.shape
    values = [tv for tv, _ in boundaries]
    if len(set(values)) != len(values):
        raise ValueError(f"boundary node types declared twice: {values}")
    spec = np.full(types.shape, -1, np.int16)
    for k, tv in enumerate(values):
        spec[types == tv] = k
    bt = np.nonzero((spec >= 0).any(axis=1))[0].astype(np.int32)
    if not len(bt):
        return None
    if (t + 1) * lat.q * n >= 2 ** 31:
        raise ValueError(f"{t} tiles: offsets into a replica pass int32")
    rows = build_stream_tables(tiling, lat, "xyz", periodic, tiles=bt)
    packed = packed_gather_indices(rows.gather_idx, lat.q, t, n)   # (Q, B, n)
    bi, slots = np.nonzero(spec[bt] >= 0)
    return BoundaryNodes(tiles=bt[bi], slots=slots.astype(np.int32),
                         spec=spec[bt[bi], slots].astype(np.uint8),
                         src=np.ascontiguousarray(packed[:, bi, slots]), num_tiles=t)


def apply_split_stream(f_store, solid, *, intra, is_cross, nbr, case,
                       bounce_dst, irregular_dst, irregular_src, opp, perms):
    """Split-phase pull streaming: storage-layout ``f_store`` (..., Q, T, n)
    -> post-streaming ``f_in`` (..., Q, T, n) in node-axis (slot) order.

    Phase 1 (interior): ONE (Q, n) index table broadcast over the tile
    axis.  Phase 2 (frontier): cross-tile sources are computed from the
    (T, 27) neighbour table and the same (Q, n) tables; bounce links are
    written from a compact flat destination list (their source recomputed
    from ``opp``/``perms``), and the rare statically unpredictable links
    from explicit (dst, src) pairs.  Solid destinations are zeroed — their
    post-collision value is masked to zero anyway, which keeps 'full'-mode
    steps bitwise equal to the monolithic gather.  Leading axes (an
    ensemble's batch) share every table.  Index tensors are int64.
    """
    *lead, q, t, n = f_store.shape
    m = t * n
    flat = f_store.reshape(*lead, q * m)
    with phase_scope("lbm.phase.stream_interior"):
        f_in = torch.gather(f_store, -1, intra[:, None, :].expand(f_store.shape))
    with phase_scope("lbm.phase.stream_frontier"):
        src_tile = nbr[:, case].movedim(0, 1)                       # (Q, T, n)
        idx = (torch.arange(q, device=nbr.device)[:, None, None] * m
               + src_tile * n + intra[:, None, :])
        f_cross = flat.index_select(-1, idx.reshape(-1)).reshape(f_store.shape)
        f_in = torch.where(is_cross[:, None, :], f_cross, f_in).reshape(*lead, q * m)
        if bounce_dst.numel():
            dq, rem = bounce_dst // m, bounce_dst % m
            dt, ds = rem // n, rem % n
            src = opp[dq] * m + dt * n + perms.reshape(-1)[opp[dq] * n + ds]
            f_in[..., bounce_dst] = flat.index_select(-1, src)
        if irregular_dst.numel():
            f_in[..., irregular_dst] = flat.index_select(-1, irregular_src)
        f_in = f_in.reshape(f_store.shape)
    return f_in.masked_fill(solid[None], 0.0)


class GatherBackend:
    """One-gather-per-direction streaming + torch (or K2) collision.

    With ``cfg.split_stream`` the monolithic (Q, T, n) gather is replaced
    by the split-phase path (:func:`apply_split_stream`).  Output is
    bitwise equal in 'full' mode; in 'propagation_only' mode solid slots
    read zero instead of the monolithic path's bounce value.
    """

    name = "gather"

    def __init__(self, cfg, lat, tiling: Tiling, tables: StreamTables,
                 device: torch.device):
        self.cfg, self.lat, self.tiling = cfg, lat, tiling
        types = tiling.node_types
        self._solid = torch.as_tensor(types == SOLID, device=device)
        self._bc_masks = [(torch.as_tensor(types == tv, device=device), spec)
                          for tv, spec in cfg.boundaries]
        self._split = self._gather = None
        if cfg.split_stream:
            sp = tables.split

            def idx(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)

            self._split = {
                "intra": idx(sp.intra_idx), "case": idx(sp.case),
                "is_cross": torch.as_tensor(sp.is_cross, device=device),
                "nbr": idx(sp.nbr), "bounce_dst": idx(sp.bounce_dst),
                "irregular_dst": idx(sp.irregular_dst),
                "irregular_src": idx(sp.irregular_src), "opp": idx(sp.opp),
                "perms": idx(tables.perms),
            }
        else:
            self._gather = torch.as_tensor(tables.gather_idx.reshape(lat.q, -1),
                                           dtype=torch.int64, device=device)
        t, n = tiling.num_tiles, tiling.nodes_per_tile
        self._perms = torch.as_tensor(tables.perms, dtype=torch.int64,
                                      device=device)[:, None, :].expand(lat.q, t, n)
        self._inv_perms = torch.as_tensor(tables.inv_perms, dtype=torch.int64,
                                          device=device)[:, None, :].expand(lat.q, t, n)

    # ------------------------------------------------- layout shuffles
    def to_storage(self, f_canon: torch.Tensor) -> torch.Tensor:
        """canonical node order -> per-direction storage layout, over any
        leading axes."""
        if self.cfg.layout_scheme == "xyz":
            return f_canon
        return torch.gather(f_canon, -1, self._inv_perms.expand(f_canon.shape))

    def canonical(self, f_store: torch.Tensor) -> torch.Tensor:
        if self.cfg.layout_scheme == "xyz":
            return f_store
        return torch.gather(f_store, -1, self._perms.expand(f_store.shape))

    def load_kernel(self) -> None:
        """Build (on a checkout's first run) and load K2's library where the
        step launches it: on the card with ``use_kernel``."""
        if self.cfg.use_kernel and self._solid.device.type == "cuda":
            build.load("collide")

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

    def _stream(self, f_store: torch.Tensor) -> torch.Tensor:
        """Streaming + bounce-back of (..., Q, T, n) storage-layout states,
        every leading axis through the same tables."""
        if self._split is not None:
            return apply_split_stream(f_store, self._solid, **self._split)
        with phase_scope("lbm.phase.stream"):
            flat = f_store.reshape(*f_store.shape[:-3], -1)
            return flat.index_select(-1, self._gather.reshape(-1)) \
                .reshape(f_store.shape)

    def _relax(self, f_in: torch.Tensor) -> torch.Tensor:
        """Open boundaries, collision and solid masking of one post-streaming
        (Q, T, n) state, back in the storage layout."""
        with phase_scope("lbm.phase.boundary"):
            for mask, spec in self._bc_masks:
                f_in = apply_open_boundary(f_in, mask, spec, self.lat)
        with phase_scope("lbm.phase.collide"):
            f_out = self._collide(f_in)
        with phase_scope("lbm.phase.pack"):
            return self.to_storage(f_out.masked_fill(self._solid[None], 0.0))

    def step(self, f_store: torch.Tensor) -> torch.Tensor:
        if self.cfg.kernel_mode == "rw_only":
            # paper §4.1: read + write the node's own data, no propagation
            return f_store.clone()
        f_in = self._stream(f_store)
        if self.cfg.kernel_mode == "propagation_only":
            return self.to_storage(f_in)
        return self._relax(f_in)

    # ------------------------------------------------- ensemble (B states)
    def ensemble_state(self, f_canon: torch.Tensor, batch: int) -> torch.Tensor:
        """B copies of one canonical (Q, T, n) state: (B, Q, T, n) storage."""
        return self.to_storage(f_canon)[None].repeat(batch, 1, 1, 1)

    def ensemble_step(self, fb: torch.Tensor) -> torch.Tensor:
        """One step of B states: one streaming pass for the whole batch,
        then each replica relaxed on its own contiguous slice by the single
        step's functions (sums over q in the single engine's order)."""
        if self.cfg.kernel_mode == "rw_only":
            return fb.clone()
        f_in = self._stream(fb)
        if self.cfg.kernel_mode == "propagation_only":
            return self.to_storage(f_in)
        return torch.stack([self._relax(f) for f in f_in.unbind(0)])

    def ensemble_canonical(self, fb: torch.Tensor) -> torch.Tensor:
        return self.canonical(fb)

    def replica_canonical(self, fb: torch.Tensor, b: int) -> torch.Tensor:
        return self.canonical(fb[b])

    def ensemble_set(self, fb: torch.Tensor, b: int,
                     f_canon: torch.Tensor) -> None:
        """Seat replica ``b`` from a canonical (Q, T, n) state, in place."""
        fb[b] = self.to_storage(f_canon.to(fb.dtype))


class FusedBackend:
    """Persistent packed (T+1, Q, n) state + the fused kernel K1."""

    name = "fused"

    def __init__(self, cfg, lat, tiling: Tiling, device: torch.device):
        if cfg.layout_scheme != "xyz":
            raise ValueError(
                "backend='fused' keeps f in the kernel's packed tile layout; "
                f"layout_scheme must be 'xyz' (got {cfg.layout_scheme!r})")
        self.cfg, self.lat, self.tiling = cfg, lat, tiling
        self.device = device
        t, n = tiling.num_tiles, tiling.nodes_per_tile
        types = np.full((t + 1, n), SOLID, np.uint8)
        types[:t] = tiling.node_types
        self._types = torch.as_tensor(types, device=device)
        self._nbrs = torch.as_tensor(build_neighbor_table(tiling, cfg.periodic),
                                     device=device)
        self._solid = torch.as_tensor(tiling.node_types == SOLID, device=device)
        bc = (boundary_pass_tables(tiling, lat, cfg.boundaries, cfg.periodic)
              if cfg.boundaries and cfg.kernel_mode == "full" else None)
        self._bc = None if bc is None else bc.to(device)
        self._specs = tuple(spec for _, spec in cfg.boundaries)
        self._bufs: tuple[torch.Tensor, torch.Tensor] | None = None
        self._ens_tables: dict[int, tuple] = {}

    def load_kernel(self) -> None:
        """Build (on a checkout's first run, one nvcc each, together) and
        load K1's library and, with boundary nodes, the NEBB pass's, where
        the step launches them: on the card."""
        if self.device.type == "cuda":
            names = ("stream_collide",) + (("nebb_pass",) if self._bc is not None else ())
            build.build_all(names)
            for name in names:
                build.load(name)

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
    def _advance(self, f, out, types, nbrs, bc) -> torch.Tensor:
        """K1 from ``f`` into ``out``, then the NEBB pass over ``bc``'s
        nodes."""
        cfg = self.cfg
        with phase_scope("lbm.phase.stream_collide"):
            stream_collide_tiles(f, types, nbrs, self.lat, cfg.collision,
                                 a=cfg.a, force=cfg.force,
                                 mode=cfg.kernel_mode,
                                 node_order=cfg.node_order, out=out)
        if bc is not None:
            self.boundary_pass(f, out, bc)
        return out

    def boundary_pass(self, f, out, bc=None) -> None:
        """The NEBB pass alone over ``bc``'s nodes (default: the engine's;
        none without boundary nodes) of every replica of ``f``, from the
        pre-step ``f`` into ``out``, in place."""
        bc = self._bc if bc is None else bc
        if bc is not None:
            nebb_boundary_pass(f, out, self.lat, self.cfg.collision,
                               self.cfg.force, self._specs, bc)

    def stream_collide(self, f: torch.Tensor) -> torch.Tensor:
        """K1 alone from ``f`` into the other buffer of the pair; a step is
        this and then :meth:`boundary_pass`."""
        return self._advance(f, self.other(f), self._types, self._nbrs, None)

    def step(self, f: torch.Tensor) -> torch.Tensor:
        return self._advance(f, self.other(f), self._types, self._nbrs,
                             self._bc)

    # ------------------------------------------------- ensemble (B states)
    def _ensemble_tables(self, batch: int):
        """Replicated kernel tables for a B-replicated packed state.

        Replica b's tiles occupy rows [b*T, (b+1)*T); the single scratch
        row moves to B*T.  The neighbour table gets the per-replica row
        offset folded in (scratch references remapped to B*T).  The NEBB
        tables are the engine's own: the pass takes B from the state's rows
        and adds replica b's base ``b * T * Q * n`` in 64 bits (it passes
        2**31 at B = 8 on the largest case).  Built once per batch size and
        shared by every ensemble of this backend.
        """
        if batch in self._ens_tables:
            return self._ens_tables[batch]
        t, n = self.tiling.num_tiles, self.tiling.nodes_per_tile
        nbrs = torch.cat([torch.where(self._nbrs == t, batch * t, self._nbrs + b * t)
                          for b in range(batch)])
        types = self._types.new_full((batch * t + 1, n), SOLID)
        types[:batch * t] = self._types[:t].repeat(batch, 1)
        tables = (types, nbrs, self._bc)
        self._ens_tables[batch] = tables
        return tables

    def ensemble_state(self, f_canon: torch.Tensor, batch: int) -> torch.Tensor:
        """B copies of one canonical (Q, T, n) state in a new zeroed
        (B*T + 1, Q, n) buffer (scratch row B*T zero)."""
        q, t, n = f_canon.shape
        f = f_canon.new_zeros((batch * t + 1, q, n))
        f[:-1].view(batch, t, q, n)[:] = f_canon.movedim(0, 1)
        return f

    def ensemble_step(self, f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """One launch of K1 over all B*T tiles from ``f`` into ``out`` (a
        buffer of the same shape whose scratch row is zero), then the NEBB
        pass over every replica's boundary nodes; B comes from the shape."""
        types, nbrs, bc = self._ensemble_tables(
            (f.shape[0] - 1) // self.tiling.num_tiles)
        return self._advance(f, out, types, nbrs, bc)

    def ensemble_canonical(self, f: torch.Tensor) -> torch.Tensor:
        """(B*T + 1, Q, n) -> (B, Q, T, n) view, for diagnostics."""
        t = self.tiling.num_tiles
        return f[:-1].view(-1, t, *f.shape[1:]).transpose(1, 2)

    def replica_canonical(self, f: torch.Tensor, b: int) -> torch.Tensor:
        t = self.tiling.num_tiles
        return f[b * t:(b + 1) * t].movedim(0, 1)

    def ensemble_set(self, f: torch.Tensor, b: int,
                     f_canon: torch.Tensor) -> None:
        """Seat replica ``b`` from a canonical (Q, T, n) state, in place."""
        t = self.tiling.num_tiles
        f[b * t:(b + 1) * t] = f_canon.movedim(0, 1)
