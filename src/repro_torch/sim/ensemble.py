"""EnsembleLBM — B independent flow states over one geometry's tables.

The port of ``repro.sim.ensemble``.  The paper's central cost on sparse
geometries is indirection-table bandwidth during propagation; batching B
states over ONE tiling and ONE set of stream tables amortises it.  On the
gather backend every index table serves all B replicas, so index bytes per
node update fall exactly as 1/B; on the fused backend the (T, 27)
neighbour table is replicated per replica and only the static (Q, n) pull
tables amortise (``index_bytes_per_step`` accounts per backend, with the
reference's formula).

Batch representation is backend-owned (``repro_torch.core.backends``):

* gather — f carries a leading batch axis (B, Q, T, n); every replica
  stays bitwise equal to an independent engine.
* fused — the packed tile axis is replicated, (B*T + 1, Q, n), with one
  shared zero scratch row; one launch of K1 over B*T tiles advances every
  replica.  The ensemble owns a pair of such buffers and ping-pongs
  between them; the engine's own pair is never touched.

Replica slots are independently settable and readable (``set_replica`` /
``replica_canonical``), which is what lets ``repro_torch.sim.service``
treat them as fixed session slots.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..core import collision as col


class EnsembleLBM:
    """Batched stepping over a shared
    :class:`~repro_torch.core.engine.SparseTiledLBM`.

    The wrapped engine provides every geometry product (tiling, stream
    tables, backend tables) and its own state is untouched; the ensemble
    owns only the batched state ``self.f`` (and, on fused, the second
    buffer of its ping-pong pair).
    """

    def __init__(self, engine, batch: int):
        if batch < 1:
            raise ValueError(f"batch must be >= 1 (got {batch})")
        if engine.cfg.backend == "gather" and engine.cfg.use_kernel:
            raise ValueError(
                "ensemble stepping on the gather backend requires "
                "use_kernel=False (the collision kernel steps one state); "
                "use backend='fused' for a kernelised ensemble")
        self.engine = engine
        self.batch = batch
        self.backend = engine.backend
        self._feq = engine._initial_feq()            # canonical (Q, T, n)
        self.f = self.backend.ensemble_state(self._feq, batch)
        # fused: the buffer the next step writes (scratch row zero); the
        # gather step allocates its result
        self._spare = (torch.zeros_like(self.f) if self.backend.name == "fused"
                       else None)
        # flat (T*n) positions of the fluid nodes, canonical order: the
        # service's finish reductions index with it instead of a boolean
        # mask, whose size the host would have to wait for
        self.fluid_index = torch.nonzero(~self.backend._solid.flatten()).squeeze(1)

    # ------------------------------------------------------------- plumbing
    @property
    def cfg(self):
        return self.engine.cfg

    @property
    def tiling(self):
        return self.engine.tiling

    @property
    def lat(self):
        return self.engine.lat

    # ----------------------------------------------------------------- step
    def _advance(self) -> None:
        if self._spare is None:
            self.f = self.backend.ensemble_step(self.f)
        else:
            self.f, self._spare = (self.backend.ensemble_step(self.f, self._spare),
                                   self.f)

    def step(self, steps: int = 1) -> None:
        tr = obs.get_tracer()
        with tr.span("lbm.ensemble.step", batch=self.batch, steps=steps,
                     **self.engine._physics):
            for _ in range(steps):
                self._advance()
        reg = obs.get_metrics()
        if reg.enabled:
            reg.counter("lbm.step_total").inc(steps)

    def run(self, steps: int) -> None:
        """``steps`` iterations for all replicas, nothing synchronised."""
        tr = obs.get_tracer()
        with tr.span("lbm.ensemble.run", batch=self.batch, steps=steps,
                     **self.engine._physics):
            for _ in range(steps):
                self._advance()
        reg = obs.get_metrics()
        if reg.enabled:
            reg.counter("lbm.step_total").inc(steps)

    # ------------------------------------------------------------ state i/o
    def reset(self, b: int | None = None) -> None:
        """Reset one replica (or all of them) to the equilibrium state."""
        if b is None:
            self.f = self.backend.ensemble_state(self._feq, self.batch)
        else:
            self.backend.ensemble_set(self.f, b, self._feq)

    def set_replica(self, b: int, f_canon) -> None:
        """Seat replica ``b`` from a CANONICAL (Q, T, n) state (the layout
        ``replica_canonical`` returns and checkpoints store)."""
        f = torch.as_tensor(f_canon, dtype=self.engine.dtype,
                            device=self.engine.device)
        self.backend.ensemble_set(self.f, b, f)

    def replica_canonical(self, b: int) -> torch.Tensor:
        """Replica ``b`` as a canonical (Q, T, n) tensor (a view of the live
        state where the layout allows: copy it before stepping again)."""
        return self.backend.replica_canonical(self.f, b)

    def canonical(self) -> torch.Tensor:
        """All replicas, canonical: (B, Q, T, n)."""
        return self.backend.ensemble_canonical(self.f)

    # ----------------------------------------------------------- diagnostics
    def macroscopics(self, b: int | None = None):
        """(rho, u) for replica ``b`` — or for all replicas with a leading
        batch axis when ``b`` is None."""
        solid = self.backend._solid                      # (T, n)
        rho0 = self.cfg.rho0
        if b is not None:
            rho, u = col.macroscopics(self.replica_canonical(b), self.lat,
                                      self.cfg.collision.fluid)
            return (torch.where(solid, torch.full_like(rho, rho0), rho),
                    u.masked_fill(solid[None], 0.0))
        f = self.canonical().movedim(1, 0)               # (Q, B, T, n)
        rho, u = col.macroscopics(f, self.lat, self.cfg.collision.fluid)
        return (torch.where(solid[None], torch.full_like(rho, rho0), rho),
                u.movedim(1, 0).masked_fill(solid[None, None], 0.0))

    def total_mass(self) -> np.ndarray:
        """Per-replica total mass, shape (B,)."""
        f = self.canonical().masked_fill(self.backend._solid[None, None], 0.0)
        return f.sum(dim=(1, 2, 3)).cpu().numpy()

    def replica_mass(self, b: int) -> float:
        """Total mass of ONE replica."""
        return float(self.replica_mass_tensor(b))

    def replica_mass_tensor(self, b: int) -> torch.Tensor:
        """Total mass of ONE replica as a 0-d tensor where the state lives
        (the service takes a slot's mass on every seat and finish without
        waiting for it)."""
        f = self.replica_canonical(b)
        return f.masked_fill(self.backend._solid[None], 0.0).sum()

    # ------------------------------------------------------------ accounting
    @property
    def n_fluid_nodes(self) -> int:
        """Fluid nodes PER REPLICA (multiply by ``batch`` for aggregate)."""
        return self.engine.n_fluid_nodes

    def aggregate_mflups(self, seconds_per_step: float) -> float:
        """Million fluid-node updates/s across ALL replicas."""
        return self.batch * self.n_fluid_nodes / seconds_per_step / 1e6

    def index_bytes_per_step(self) -> int:
        """Indirection-table bytes ONE batched step loads.

        gather: every table serves all B replicas — the single-engine
        figure.  fused: the (T, 27) neighbour table is materialised PER
        REPLICA, so that term scales with B; the static (Q, n) pull tables
        stay a single copy.
        """
        if self.cfg.backend == "fused":
            extra_nbr = 27 * self.tiling.num_tiles * 4
            return (self.engine.index_bytes_per_step()
                    + (self.batch - 1) * extra_nbr)
        return self.engine.index_bytes_per_step()

    def index_bytes_per_node_update(self) -> float:
        """Indirection-table bytes loaded per fluid-node update (1/B on
        gather; on fused the per-replica neighbour table is the floor)."""
        return (self.index_bytes_per_step()
                / (self.batch * max(1, self.n_fluid_nodes)))
