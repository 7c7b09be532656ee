"""Slab-decomposed LBM — the paper's sparse tiled engine cut into z slabs,
on one card, on several cards of one process, or one slab per
``torch.distributed`` rank.

The port of ``repro.dist.lbm``.  The tiler orders ``Tiling.tile_coords``
with z tile-layers contiguous (``tile_order`` 'zmajor' or 'morton_slab',
:data:`~repro_torch.core.tiling.SLAB_COMPATIBLE_ORDERS`), so contiguous runs
of z tile-layers form slabs.  :func:`make_slab_plan` cuts the tile-layer
axis into ``n_dev`` contiguous slabs balanced by fluid-node count; each slab
holds its OWN tile layers plus one replicated HALO tile-layer per cut face
(streaming reaches one node, so one a-thick tile layer per side is enough
for one step between exchanges).

Each slab is just another sparse tiled problem: its geometry is re-tiled
with the host tiler and gets its own single-engine backend
(:func:`repro_torch.core.backends.make_backend`) with its own stream tables
(gather) or neighbour table and NEBB tables (fused), so cross-slab links
resolve into the local halo tiles with no special case.  One step of
:class:`ShardedLBM` is

1. the halo exchange (:class:`LocalExchange` or
   :class:`DistributedExchange`): each slab's boundary owned tile layer is
   copied into its neighbour's halo layer — whole (Q, n) tile rows of the
   packed fused state, (Q, ·, n) columns of the gather state, no layout
   shuffle;
2. each slab's backend step: on ``fused`` one launch of the fused kernel K1
   per slab, then the NEBB pass on the slabs with boundary nodes (each
   from its slab's pre-step state, halo rows included); on ``gather``
   streaming and the collision (kernel K2 per slab with ``use_kernel``).

The reference pads every slab to a common ``t_pad`` tiles and uses slot
``t_pad - 1`` as K1's scratch tile; here each slab keeps its own T tiles
and its own scratch row T.  Owned-tile values are the same either way (the
update is elementwise given identical inputs), and :meth:`macroscopics_own`
returns the reference's padded shapes.  K1 also updates the halo tiles, as
in the reference; the next exchange overwrites them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..core import collision as col
from ..core.backends import make_backend
from ..core.engine import DTYPES, LBMConfig, initial_feq
from ..core.lattice import get_lattice
from ..core.streaming import StreamTables, build_stream_tables
from ..core.tiling import (SLAB_COMPATIBLE_ORDERS, SOLID, Tiling,
                           tile_geometry)
from ..device import resolve_device
from ..roofline.count import Counter

UP, DOWN = 0, 1          # a hop's direction along z (its message tag)


# ==========================================================================
# host-side slab plan (numpy; the reference's, line for line)
# ==========================================================================
def balanced_layer_partition(weights: np.ndarray, n_dev: int):
    """Cut ``len(weights)`` layers into ``n_dev`` contiguous slabs whose
    weight sums are as equal as the layer granularity allows.

    Every slab gets at least one layer.  Returns [(zl, zh), ...) half-open.
    """
    tz = len(weights)
    assert tz >= n_dev, f"{tz} tile layers cannot feed {n_dev} slabs"
    cum = np.cumsum(np.asarray(weights, np.float64))
    total = cum[-1]
    bounds = [0]
    for d in range(1, n_dev):
        target = total * d / n_dev
        k = int(np.argmin(np.abs(cum - target)))     # closest cut point
        z = max(k + 1, bounds[-1] + 1)               # >= 1 layer each
        z = min(z, tz - (n_dev - d))                 # leave layers behind
        bounds.append(z)
    bounds.append(tz)
    return [(bounds[d], bounds[d + 1]) for d in range(n_dev)]


def _tiles_at_layer(t: Tiling, layer: int) -> np.ndarray:
    """Local tile ids of one z tile-layer.

    For every slab-compatible ``tile_order`` the order WITHIN a layer is a
    pure function of (x, y) — (y, x)-sorted for 'zmajor', 2-D Morton for
    'morton_slab' — so two slabs that both hold the layer enumerate its
    tiles identically and halo send/recv lists line up element-wise."""
    return np.nonzero(t.tile_coords[:, 2] == layer)[0].astype(np.int32)


@dataclasses.dataclass
class SlabPlan:
    """Host-side slab decomposition of the tile grid along z."""

    n_dev: int
    a: int
    tile_layers: int                       # TZ of the global tile grid
    layer_of_dev: list                     # [(zl, zh)) owned tile layers
    own_z0: list                           # local layer index of first owned
    local_tilings: list                    # per-slab Tiling (own + halo)
    own: np.ndarray                        # (D, t_pad) owned-tile mask
    t_max: int                             # max local tile count
    t_pad: int                             # t_max + 1 (last slot = dummy)
    n_fluid_own: int                       # owned non-solid nodes (global)
    periodic_z: bool
    tile_order: str = "zmajor"             # slab-compatible traversal
    node_order: str = "canonical"          # within-tile node enumeration
    tile_utilisation: float = 0.0          # global eta_t (Eqn 14)

    @property
    def nodes_per_tile(self) -> int:
        return self.a ** 3

    def owned_layer_range_local(self, d: int):
        """Local tile-layer index range [lo, hi) of slab d's OWNED tiles."""
        zl, zh = self.layer_of_dev[d]
        return self.own_z0[d], self.own_z0[d] + (zh - zl)

    def halo_layers_local(self, d: int):
        """Local tile-layer indices of the halo (0, 1, or 2 entries)."""
        lo, hi = self.owned_layer_range_local(d)
        out = []
        if lo > 0:
            out.append(0)
        tz_local = self.local_tilings[d].tile_grid[2]
        if hi < tz_local:
            out.append(hi)
        return out

    def owned_rows(self, d: int, tiling: Tiling) -> tuple[np.ndarray, np.ndarray]:
        """Slab d's owned local tile rows, and the same tiles' rows in
        ``tiling``, the single engine's tiling of the whole geometry (local
        layers shift by the slab's first owned layer, wrapping in z)."""
        lt = self.local_tilings[d]
        rows = np.nonzero(self.own[d, :lt.num_tiles])[0]
        c = lt.tile_coords[rows].astype(np.int64)
        c[:, 2] = (c[:, 2] + self.layer_of_dev[d][0] - self.own_z0[d]) \
            % self.tile_layers
        return rows, tiling.tile_map[c[:, 0], c[:, 1], c[:, 2]]


def make_slab_plan(node_type: np.ndarray, a: int, n_dev: int,
                   periodic_z: bool = False,
                   tile_order: str = "zmajor",
                   node_order: str = "canonical") -> SlabPlan:
    """Slab-decompose a dense geometry into ``n_dev`` z slabs of tiles.

    ``tile_order`` must keep z tile-layers contiguous (SLAB_COMPATIBLE_
    ORDERS): global space-filling orders ('morton', 'hilbert') interleave
    layers, which would break both the contiguous-slab invariant and the
    halo tile-row alignment between neighbouring slabs.  ``node_order``
    permutes nodes within tiles only, so it composes with every
    slab-compatible tile order.
    """
    if tile_order not in SLAB_COMPATIBLE_ORDERS:
        raise ValueError(
            f"tile_order {tile_order!r} is not slab-compatible; the slab "
            f"decomposition needs one of {SLAB_COMPATIBLE_ORDERS} "
            "(use 'morton_slab' for in-layer locality)")
    node_type = np.ascontiguousarray(node_type.astype(np.uint8))
    g_tiling = tile_geometry(node_type, a, order=tile_order,
                             node_order=node_order)
    tz = g_tiling.tile_grid[2]
    wrap = periodic_z and n_dev > 1
    if wrap:
        assert tz >= 2 * n_dev, (
            f"periodic z needs >= 2 tile layers per slab ({tz} vs {n_dev})")

    # balance on fluid nodes per tile layer (tiles can be nearly empty)
    fluid_per_tile = (g_tiling.node_types != SOLID).sum(axis=1)
    weights = np.bincount(g_tiling.tile_coords[:, 2],
                          weights=fluid_per_tile, minlength=tz)
    layer_of_dev = balanced_layer_partition(weights, n_dev)

    if wrap:
        # wrapped slices need the z-padded dense geometry
        pad_z = (-node_type.shape[2]) % a
        padded = np.pad(node_type, ((0, 0), (0, 0), (0, pad_z)),
                        constant_values=SOLID) if pad_z else node_type

    local_tilings, own_z0 = [], []
    for zl, zh in layer_of_dev:
        if wrap:
            layers = [(zl - 1) % tz] + list(range(zl, zh)) + [zh % tz]
            sub = np.concatenate(
                [padded[:, :, l * a:(l + 1) * a] for l in layers], axis=2)
            z0 = 1
        else:
            g_lo, g_hi = max(0, zl - 1), min(tz, zh + 1)
            sub = node_type[:, :, g_lo * a: g_hi * a]
            if sub.shape[2] < (g_hi - g_lo) * a:       # orig z not % a
                sub = np.pad(
                    sub, ((0, 0), (0, 0),
                          (0, (g_hi - g_lo) * a - sub.shape[2])),
                    constant_values=SOLID)
            z0 = zl - g_lo
        local_tilings.append(tile_geometry(sub, a, order=tile_order,
                                           node_order=node_order))
        own_z0.append(z0)

    t_max = max(t.num_tiles for t in local_tilings)
    t_pad = t_max + 1
    own = np.zeros((n_dev, t_pad), bool)
    n_fluid_own = 0
    for d, lt in enumerate(local_tilings):
        lo = own_z0[d]
        hi = lo + (layer_of_dev[d][1] - layer_of_dev[d][0])
        zc = lt.tile_coords[:, 2]
        own[d, :lt.num_tiles] = (zc >= lo) & (zc < hi)
        n_fluid_own += int(
            (lt.node_types[own[d, :lt.num_tiles]] != SOLID).sum())
    assert n_fluid_own == g_tiling.n_fluid_nodes, (
        n_fluid_own, g_tiling.n_fluid_nodes)

    return SlabPlan(n_dev=n_dev, a=a, tile_layers=tz,
                    layer_of_dev=layer_of_dev, own_z0=own_z0,
                    local_tilings=local_tilings, own=own,
                    t_max=t_max, t_pad=t_pad, n_fluid_own=n_fluid_own,
                    periodic_z=bool(periodic_z), tile_order=tile_order,
                    node_order=node_order,
                    tile_utilisation=g_tiling.tile_utilisation)


# ==========================================================================
# halo lists
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class HaloHop:
    """Slab ``src``'s boundary owned tile layer into slab ``dst``'s halo
    layer: local tile rows ``send`` of src land on rows ``recv`` of dst,
    element for element."""

    src: int
    dst: int
    send: np.ndarray         # (h,) int64
    recv: np.ndarray         # (h,) int64
    direction: int           # UP: dst's bottom halo; DOWN: its top halo


def halo_lists(plan: SlabPlan) -> tuple[list[HaloHop], dict[str, np.ndarray]]:
    """The hops of one exchange, and the reference's padded (D, h) tables
    ``su``/``sd`` (each slab's top/bottom owned layer), ``ru``/``rd`` (its
    bottom/top halo layer) with masks ``rum``/``rdm``; pads point at the
    dummy slot ``t_pad - 1``, and h is the widest layer.  One slab has no
    hops and no tables.  Hops come in a fixed order (receiving slab, then
    bottom before top), the same on every rank."""
    d_cnt, dummy = plan.n_dev, plan.t_pad - 1
    if d_cnt <= 1:
        return [], {}
    tilings = plan.local_tilings
    up_send = [_tiles_at_layer(lt, plan.owned_layer_range_local(d)[1] - 1)
               for d, lt in enumerate(tilings)]
    dn_send = [_tiles_at_layer(lt, plan.owned_layer_range_local(d)[0])
               for d, lt in enumerate(tilings)]
    h = max(1, max(len(s) for s in up_send + dn_send))

    def pack(lists):
        out = np.full((d_cnt, h), dummy, np.int32)
        for d, ids in enumerate(lists):
            out[d, :len(ids)] = ids
        return out

    ru = np.full((d_cnt, h), dummy, np.int32)
    rum = np.zeros((d_cnt, h), bool)
    rd = np.full((d_cnt, h), dummy, np.int32)
    rdm = np.zeros((d_cnt, h), bool)
    hops = []
    for d in range(d_cnt):
        lo, hi = plan.owned_layer_range_local(d)
        if lo > 0:          # bottom halo <- previous slab's top
            prev = (d - 1) % d_cnt
            ids = _tiles_at_layer(tilings[d], 0)
            assert len(ids) == len(up_send[prev]), (d, "up")
            ru[d, :len(ids)] = ids
            rum[d, :len(ids)] = True
            if len(ids):
                hops.append(HaloHop(prev, d, up_send[prev].astype(np.int64),
                                    ids.astype(np.int64), UP))
        if hi < tilings[d].tile_grid[2]:   # top halo <- next slab's bottom
            nxt = (d + 1) % d_cnt
            ids = _tiles_at_layer(tilings[d], hi)
            assert len(ids) == len(dn_send[nxt]), (d, "down")
            rd[d, :len(ids)] = ids
            rdm[d, :len(ids)] = True
            if len(ids):
                hops.append(HaloHop(nxt, d, dn_send[nxt].astype(np.int64),
                                    ids.astype(np.int64), DOWN))
    return hops, dict(su=pack(up_send), sd=pack(dn_send),
                      ru=ru, rum=rum, rd=rd, rdm=rdm)


# ==========================================================================
# halo exchanges
# ==========================================================================
class LocalExchange:
    """Every slab in this process, on any devices (one card holding all D
    slabs, or several cards).  A hop is an ``index_select`` of the sender's
    rows and an ``index_copy_`` into the receiver's, all on the current
    streams: nothing waits for the host.  Between two cards the copy is
    ``Tensor.to(non_blocking=True)``, which orders itself after the
    sender's stream and before the receiver's with events.

    Send rows are owned tiles and receive rows halo tiles, so no hop reads
    what another writes: the hops run one after the other.
    """

    def slabs(self, n_slabs: int) -> list[int]:
        """The slabs this process holds."""
        return list(range(n_slabs))

    def bind(self, hops: list[HaloHop], axis: int,
             devices: dict[int, torch.device]) -> None:
        """Put the hops' row indices on the devices that use them; ``axis``
        is the tile axis of the slab states (0 for packed (T+1, Q, n), 1
        for (Q, T, n))."""
        self.axis = axis
        self._hops = [(h.src, h.dst,
                       torch.as_tensor(h.send, device=devices[h.src]),
                       torch.as_tensor(h.recv, device=devices[h.dst]))
                      for h in hops]

    def exchange(self, states: dict[int, torch.Tensor]) -> None:
        """Copy every hop's rows, in place on the receivers' states."""
        for src, dst, send, recv in self._hops:
            rows = states[src].index_select(self.axis, send)
            out = states[dst]
            out.index_copy_(self.axis, recv, rows.to(out.device, non_blocking=True))

    def total(self, value: float) -> float:
        """The sum of ``value`` over the processes of the exchange."""
        return value


class DistributedExchange:
    """One slab per rank of a ``torch.distributed`` process group (slab i
    on group rank i): the rows travel with ``batch_isend_irecv``, gloo on
    the CPU, NCCL between cards.

    On a periodic ring of two slabs, two messages go each way between the
    same two ranks.  NCCL ignores tags and matches a pair's messages in the
    order they were posted, so correctness rests on every rank posting its
    sends and receives in the same fixed hop order (:func:`halo_lists`'s);
    the direction is passed as the tag for gloo, which matches by it."""

    def __init__(self, group=None):
        self.group = group

    def slabs(self, n_slabs: int) -> list[int]:
        import torch.distributed as dist

        world = dist.get_world_size(self.group)
        if world != n_slabs:
            raise ValueError(f"DistributedExchange holds one slab per rank: "
                             f"{n_slabs} slabs on {world} ranks")
        self.rank = dist.get_rank(self.group)
        return [self.rank]

    def bind(self, hops: list[HaloHop], axis: int,
             devices: dict[int, torch.device]) -> None:
        """Keep the hops this rank sends or receives, their rows on its
        device."""
        import torch.distributed as dist

        self.axis, me = axis, self.rank
        self.device = devices[me]

        def peer(slab):
            return slab if self.group is None else dist.get_global_rank(self.group, slab)

        self._sends = [(torch.as_tensor(h.send, device=self.device), peer(h.dst),
                        h.direction) for h in hops if h.src == me]
        self._recvs = [(torch.as_tensor(h.recv, device=self.device), peer(h.src),
                        h.direction) for h in hops if h.dst == me]

    def exchange(self, states: dict[int, torch.Tensor]) -> None:
        import torch.distributed as dist

        f, axis = states[self.rank], self.axis
        ops, landed = [], []
        for rows, peer, tag in self._sends:
            ops.append(dist.P2POp(dist.isend, f.index_select(axis, rows),
                                  peer, self.group, tag=tag))
        for rows, peer, tag in self._recvs:
            shape = list(f.shape)
            shape[axis] = len(rows)
            buf = f.new_empty(shape)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag=tag))
            landed.append((rows, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for rows, buf in landed:
            f.index_copy_(axis, rows, buf)

    def total(self, value: float) -> float:
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self.group)
        return float(t)


# ==========================================================================
# the engine
# ==========================================================================
class ShardedLBM:
    """Slab-decomposed ``SparseTiledLBM``: one single-engine backend per
    slab, a halo exchange before each step.

    ``slabs`` is D (default: one per entry of ``devices`` when it is a
    list, else 1).  ``devices`` places the slabs: None puts every slab on
    the card (and raises without CUDA, as
    :func:`repro_torch.device.resolve_device` does), one device puts them
    all there, a list of D devices puts slab d on ``devices[d]``.
    ``exchange`` is a fresh :class:`LocalExchange` (the default: every slab
    in this process) or :class:`DistributedExchange` (this rank's slab
    only); the engine binds it to its halo lists.
    """

    def __init__(self, node_type: np.ndarray, cfg: LBMConfig,
                 slabs: int | None = None, devices=None, exchange=None):
        if cfg.backend == "fused" and cfg.layout_scheme != "xyz":
            raise ValueError("backend='fused' requires layout_scheme='xyz'")
        if cfg.split_stream and cfg.backend != "gather":
            raise ValueError("split_stream requires backend='gather'")
        self.cfg = cfg
        self._physics = cfg.collision.span_attrs()
        self.lat = get_lattice(cfg.lattice)
        self.dtype = DTYPES[cfg.dtype]
        self.fused = cfg.backend == "fused"
        listed = isinstance(devices, (list, tuple))
        n_slab = slabs or (len(devices) if listed else 1)
        if listed and len(devices) != n_slab:
            raise ValueError(f"{len(devices)} devices for {n_slab} slabs")
        placed = ([resolve_device(d) for d in devices] if listed
                  else [resolve_device(devices)] * n_slab)

        self.plan = make_slab_plan(node_type, cfg.a, n_slab,
                                   periodic_z=cfg.periodic[2],
                                   tile_order=cfg.tile_order,
                                   node_order=cfg.node_order)
        # periodic z is carried by the wrapped halo when sharded; a single
        # slab keeps the engine's in-table wrap
        self.slab_cfg = dataclasses.replace(
            cfg, periodic=(cfg.periodic[0], cfg.periodic[1],
                           cfg.periodic[2] and n_slab == 1))
        self._exchange = exchange if exchange is not None else LocalExchange()
        self.slab_ids = self._exchange.slabs(n_slab)
        self.devices = [placed[d] for d in self.slab_ids]
        self.device = self.devices[0]
        self._tables: dict[int, StreamTables] = {}
        self.backends = []
        for d, dev in zip(self.slab_ids, self.devices):
            lt = self.plan.local_tilings[d]
            tables = None if self.fused else self._slab_tables(d)
            self.backends.append(make_backend(cfg.backend, self.slab_cfg,
                                              self.lat, lt, tables, dev))
        self.hops, self._halo_tables = halo_lists(self.plan)
        self._exchange.bind(self.hops, 0 if self.fused else 1,
                            dict(zip(self.slab_ids, self.devices)))
        self._own_nodes = [
            torch.as_tensor(self.plan.own[d, :self.plan.local_tilings[d].num_tiles,
                                          None]
                            & (self.plan.local_tilings[d].node_types != SOLID),
                            device=dev)
            for d, dev in zip(self.slab_ids, self.devices)]
        self.reset()

    def _slab_tables(self, d: int) -> StreamTables:
        """Slab d's full stream tables (split ones with ``split_stream``),
        built once; on ``fused`` only the accounting reads them."""
        if d not in self._tables:
            self._tables[d] = build_stream_tables(
                self.plan.local_tilings[d], self.lat, self.cfg.layout_scheme,
                self.slab_cfg.periodic, split=self.cfg.split_stream)
        return self._tables[d]

    # --------------------------------------------------------------- state
    def reset(self) -> None:
        """Re-initialise every slab's f to the equilibrium state (t = 0)."""
        self.f = [b.initial_state(initial_feq(self.cfg, self.lat, b._solid,
                                              self.dtype))
                  for b in self.backends]

    # ---------------------------------------------------------------- step
    def exchange(self) -> None:
        """The halo exchange alone, in place on the slab states."""
        with obs.phase_scope("lbm.phase.halo"):
            self._exchange.exchange(dict(zip(self.slab_ids, self.f)))

    def _advance(self, steps: int) -> None:
        for _ in range(steps):
            if self.hops:
                self.exchange()
            if not self.fused:
                self.f = [b.step(f) for b, f in zip(self.backends, self.f)]
                continue
            # K1 on every slab first, then the NEBB passes (one kernel launch
            # each): the host enqueues them while the card runs the slabs' K1
            outs = [b.stream_collide(f) for b, f in zip(self.backends, self.f)]
            for b, f, out in zip(self.backends, self.f, outs):
                b.boundary_pass(f, out)
            self.f = outs

    def step(self, steps: int = 1) -> None:
        self._advance(steps)
        self._record_steps(steps)

    def run(self, steps: int) -> None:
        """``steps`` iterations: one launch sequence per step, nothing
        synchronised."""
        with obs.get_tracer().span("lbm.run", steps=steps, sharded=True,
                                   **self._physics):
            self._advance(steps)
        self._record_steps(steps)

    def _record_steps(self, steps: int) -> None:
        reg = obs.get_metrics()
        if reg.enabled:
            reg.counter("lbm.step_total").inc(steps)
            halo = self.halo_bytes_per_step()
            if halo:
                reg.gauge("dist.halo.bytes").set(halo)
                reg.counter("dist.halo.bytes_total").inc(halo * steps)

    # ----------------------------------------------------------- diagnostics
    def macroscopics_own(self):
        """(rho, u, node_types, own) stacked per slab (numpy), in the
        reference's padded shapes.

        ``rho``: (D, t_pad, a^3); ``u``: (3, D, t_pad, a^3); ``own``:
        (D, t_pad) marks tiles whose values are authoritative on slab d
        (halo + padding excluded).  Solid and padding slots read rho0 and
        zero velocity; so do the slabs of other ranks.
        """
        plan = self.plan
        d_cnt, tp, n = plan.n_dev, plan.t_pad, plan.nodes_per_tile
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        rho = np.full((d_cnt, tp, n), self.cfg.rho0, np_dtype)
        u = np.zeros((3, d_cnt, tp, n), np_dtype)
        types = np.zeros((d_cnt, tp, n), np.uint8)
        for d, lt in enumerate(plan.local_tilings):
            types[d, :lt.num_tiles] = lt.node_types
        for d, b, f in zip(self.slab_ids, self.backends, self.f):
            r, v = col.macroscopics(b.canonical(f), self.lat,
                                    self.cfg.collision.fluid)
            solid = plan.local_tilings[d].node_types == SOLID
            t = len(solid)
            rho[d, :t] = np.where(solid, self.cfg.rho0, r.cpu().numpy())
            u[:, d, :t] = np.where(solid[None], 0.0, v.cpu().numpy())
        return rho, u, types, plan.own

    def total_mass(self) -> float:
        """Sum of f over the owned fluid nodes of every slab."""
        local = sum(float(b.canonical(f).masked_fill(~own[None], 0.0).sum())
                    for b, f, own in zip(self.backends, self.f, self._own_nodes))
        return self._exchange.total(local)

    # ------------------------------------------------------------ accounting
    # the reference's formulas over its padded tables, so that its numbers
    # and these are the same
    @property
    def n_fluid_nodes(self) -> int:
        return self.plan.n_fluid_own

    def bytes_per_step(self) -> int:
        stored = sum(t.num_tiles * t.nodes_per_tile
                     for t in self.plan.local_tilings)
        return 2 * self.lat.q * self.dtype.itemsize * stored

    def halo_bytes_per_step(self) -> int:
        """Bytes the reference's halo exchange moves per step, summed over
        all slabs: each hop carries a (q, h, n) row block of f, h the
        widest exchanged layer (pads included)."""
        d_cnt = self.plan.n_dev
        if d_cnt <= 1:
            return 0
        h = self._halo_tables["su"].shape[1]
        n_hops = 2 * (d_cnt if self.plan.periodic_z else d_cnt - 1)
        return n_hops * self.lat.q * h * self.plan.nodes_per_tile * \
            self.dtype.itemsize

    def halo_bytes_moved_per_step(self) -> int:
        """Bytes this port's exchange really copies per step (no pads)."""
        rows = sum(len(h.send) for h in self.hops)
        return rows * self.lat.q * self.plan.nodes_per_tile * self.dtype.itemsize

    def index_bytes_per_step(self) -> int:
        """Indirection-table bytes loaded per step across all slabs, as the
        reference counts them over its (D, t_pad, ...) tables."""
        q, n = self.lat.q, self.plan.nodes_per_tile
        d_cnt, tp = self.plan.n_dev, self.plan.t_pad
        if self.fused:
            # (D, t_pad - 1, 27) int32 neighbour tables + one static (Q, n)
            # perm/case pair per slab
            return d_cnt * (tp - 1) * 27 * 4 + d_cnt * (q * n * 4 + q * n * 1)
        if self.cfg.split_stream:
            splits = [self._slab_tables(d).split for d in range(d_cnt)]
            b_max = max(sp.bounce_dst.size for sp in splits)
            i_max = max(sp.irregular_dst.size for sp in splits)
            frontier = d_cnt * (tp * 27 + b_max + 2 * i_max) * 4
            return frontier + d_cnt * (q * n * 4 + q * n * 4 + q * n * 1)
        return d_cnt * q * tp * n * 4

    @property
    def stream_fracs(self) -> dict[str, float]:
        """Fluid-link-weighted split-phase budget over the slabs' tables
        (halo tiles counted once per slab)."""
        tilings = self.plan.local_tilings
        w = np.asarray([lt.n_fluid_nodes for lt in tilings], np.float64)
        w = w / max(1, w.sum())
        tabs = [self._slab_tables(d) for d in range(len(tilings))]
        return {k: float(np.dot(w, [getattr(t, k) for t in tabs]))
                for k in ("interior_frac", "frontier_frac", "bounce_frac")}

    def model_metrics(self) -> dict[str, float]:
        """Modelled per-step quantities under the canonical metric names
        (``SparseTiledLBM.model_metrics``'s, plus the halo traffic)."""
        q, nf = self.lat.q, self.plan.n_fluid_own
        min_bytes = 2 * q * nf * self.dtype.itemsize     # paper Eqn (10)
        idx = self.index_bytes_per_step()
        halo = self.halo_bytes_per_step()
        actual = self.bytes_per_step() + idx + halo
        fr = self.stream_fracs
        return {
            "lbm.bw.eqn10_min_bytes": float(min_bytes),
            "lbm.bw.eqn10_fraction": min_bytes / max(1, actual),
            "lbm.bytes.model_per_node": actual / max(1, nf),
            "lbm.index.bytes_per_node": idx / max(1, nf),
            "lbm.stream.interior_frac": fr["interior_frac"],
            "lbm.stream.frontier_frac": fr["frontier_frac"],
            "lbm.stream.bounce_frac": fr["bounce_frac"],
            "lbm.tiles.utilisation": float(self.plan.tile_utilisation),
            "dist.halo.bytes": float(halo),
        }

    def mflups(self, seconds_per_step: float) -> float:
        return self.plan.n_fluid_own / seconds_per_step / 1e6

    def count_step(self, axis: str = "data") -> list:
        """One step of each slab counted as one device of a slab mesh runs
        it (``roofline.count.Counter``; build the engine with
        ``devices="meta"`` to count without allocating): the halo
        exchange's collective-permutes over mesh ``axis``, one a hop the
        slab sends, each the reference's padded (Q, h, n) block of f; then
        the slab's backend step: on ``fused`` K1 and the NEBB kernel by
        their cost functions, on ``gather`` streaming and the collision (K2
        by its cost function with ``use_kernel``).  Returns one Counter a
        slab, in slab order; the slab's state counts as resident."""
        h = self._halo_tables["su"].shape[1] if self.hops else 0
        block = self.lat.q * h * self.plan.nodes_per_tile * self.dtype.itemsize
        out = []
        for d, b, f in zip(self.slab_ids, self.backends, self.f):
            with Counter() as c:
                c.resident(f)
                for hop in self.hops:
                    if hop.src == d:
                        c.collective("collective-permute", axis, block, block)
                if self.fused:
                    b.boundary_pass(f, b.stream_collide(f))
                else:
                    b.step(f)
            out.append(c)
        return out


__all__ = ["DistributedExchange", "HaloHop", "LocalExchange", "ShardedLBM",
           "SlabPlan", "balanced_layer_partition", "halo_lists",
           "make_slab_plan"]
