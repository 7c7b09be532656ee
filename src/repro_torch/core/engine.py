"""SparseTiledLBM — the paper's solver on PyTorch.

One LBM iteration (paper Algorithm 2): pull streaming with half-way
bounce-back, open-boundary reconstruction, collision, solid masking.  The
step is pluggable (``LBMConfig.backend``, see ``repro_torch.core.backends``):

* ``backend="gather"`` — one gather per direction over the per-direction
  storage layout; ``use_kernel=True`` swaps the collision math for the
  collision kernel K2.  ``split_stream=True`` replaces the monolithic
  (Q, T, n) index table with split-phase streaming: a static (Q, n)
  interior permutation broadcast over tiles plus compact frontier tables
  (bitwise-equal streaming, see ``repro_torch.core.streaming``).
* ``backend="fused"`` — the fused stream+collide kernel K1 over state held
  persistently in the packed (T+1, Q, n) layout.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain PyTorch
version.  ``run(steps)`` is a loop of launches on the current stream; no
step synchronises with the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..kernels.stream_collide import MODES
from . import collision as col
from .backends import BACKENDS, make_backend
from .boundary import BoundarySpec
from .lattice import get_lattice
from .streaming import StreamTables, build_stream_tables
from .tiling import Tiling, tile_geometry, untile

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class LBMConfig:
    lattice: str = "D3Q19"
    collision: col.CollisionConfig = dataclasses.field(
        default_factory=col.CollisionConfig
    )
    a: int = 4                                # nodes per tile edge
    tile_order: str = "zmajor"                # tiling.TILE_ORDERS
    node_order: str = "canonical"             # tiling.NODE_ORDERS
    # split-phase streaming (gather backend only): static (Q, n) interior
    # permutation + compact frontier tables (streaming.SplitStreamTables)
    split_stream: bool = False
    layout_scheme: str = "xyz"                # 'xyz' | 'paper' | ...
    dtype: str = "float32"
    periodic: tuple[bool, bool, bool] = (False, False, False)
    # map node-type value -> open-boundary spec (walls need no spec)
    boundaries: tuple[tuple[int, BoundarySpec], ...] = ()
    force: tuple[float, float, float] | None = None
    rho0: float = 1.0
    u0: tuple[float, float, float] = (0.0, 0.0, 0.0)
    backend: str = "gather"                   # 'gather' | 'fused'
    use_kernel: bool = False                  # gather backend: kernel K2
    # paper §4.1 kernel variants: 'full' | 'propagation_only' | 'rw_only'
    kernel_mode: str = "full"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {tuple(DTYPES)}")
        if self.kernel_mode not in MODES:
            raise ValueError(f"kernel_mode must be one of {MODES}")


def initial_feq(cfg: LBMConfig, lat, solid: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The t = 0 state: the equilibrium at the uniform (rho0, u0), one
    node's Q values broadcast over every fluid slot of the (T, n) ``solid``
    mask's tiles, zero at solid slots; canonical (Q, T, n) on ``solid``'s
    device, the only allocation of that shape."""
    kw = dict(dtype=dtype, device=solid.device)
    rho = torch.full((1,), cfg.rho0, **kw)
    u = torch.as_tensor(cfg.u0, **kw)[:, None]
    feq = col.equilibrium(rho, u, lat, cfg.collision.fluid)      # (Q, 1)
    return torch.where(solid[None], 0.0, feq[:, :, None])


class SparseTiledLBM:
    """Sparse tiled LBM engine (the paper's contribution)."""

    def __init__(self, node_type: np.ndarray, cfg: LBMConfig, device=None):
        if cfg.split_stream and cfg.backend != "gather":
            raise ValueError(
                "split_stream restructures the gather backend's streaming; "
                f"backend must be 'gather' (got {cfg.backend!r} — the fused "
                "kernel already computes its pull indices from static "
                "tables)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lat = get_lattice(cfg.lattice)
        self.dtype = DTYPES[cfg.dtype]
        # the physics every span of this engine names: which instantiation
        # of K1 and of the NEBB kernel each launch under it ran
        self._physics = cfg.collision.span_attrs()
        tr = obs.get_tracer()
        with tr.span("lbm.setup", backend=cfg.backend, dtype=cfg.dtype,
                     **self._physics):
            with tr.span("lbm.setup.tiling"):
                self.tiling: Tiling = tile_geometry(node_type, cfg.a,
                                                    order=cfg.tile_order,
                                                    node_order=cfg.node_order)
            with tr.span("lbm.setup.tables"):
                # the fused backend builds stream-table rows for its
                # boundary tiles only; the full table is built on demand
                # for the link fractions
                self._tables: StreamTables | None = None
                if cfg.backend == "gather":
                    self._tables = build_stream_tables(
                        self.tiling, self.lat, cfg.layout_scheme, cfg.periodic,
                        split=cfg.split_stream)
                self.backend = make_backend(cfg.backend, cfg, self.lat,
                                            self.tiling, self._tables,
                                            self.device)
            with tr.span("lbm.setup.kernel_load"):
                self.backend.load_kernel()
            with tr.span("lbm.setup.state"):
                self._solid = self.backend._solid            # (T, n) canonical
                self.f = self.backend.initial_state(self._initial_feq())

    @property
    def tables(self) -> StreamTables:
        """The full stream tables (built on first use for ``fused``)."""
        if self._tables is None:
            self._tables = build_stream_tables(
                self.tiling, self.lat, self.cfg.layout_scheme, self.cfg.periodic)
        return self._tables

    # ------------------------------------------------------------------ init
    def _initial_feq(self) -> torch.Tensor:
        return initial_feq(self.cfg, self.lat, self._solid, self.dtype)

    def reset(self) -> None:
        """Re-initialise f to the equilibrium state (t = 0)."""
        self.f = self.backend.initial_state(self._initial_feq())

    # -------------------------------------------------------------- ensemble
    def ensemble(self, batch: int):
        """B independent flow states over THIS engine's tiling and tables,
        advanced together (``repro_torch.sim.ensemble``).  The engine's own
        state is never touched."""
        from ..sim.ensemble import EnsembleLBM

        return EnsembleLBM(self, batch)

    # ------------------------------------------------------------------ step
    def step(self, steps: int = 1) -> None:
        for _ in range(steps):
            self.f = self.backend.step(self.f)
        reg = obs.get_metrics()
        if reg.enabled:
            reg.counter("lbm.step_total").inc(steps)

    def run(self, steps: int) -> None:
        """Advance ``steps`` iterations: one launch sequence per step,
        nothing synchronised."""
        with obs.get_tracer().span("lbm.run", steps=steps, **self._physics):
            self.step(steps)

    # ----------------------------------------------------------- diagnostics
    def macroscopics(self):
        f_canon = self.backend.canonical(self.f)
        rho, u = col.macroscopics(f_canon, self.lat, self.cfg.collision.fluid)
        rho = torch.where(self._solid, torch.full_like(rho, self.cfg.rho0), rho)
        u = u.masked_fill(self._solid[None], 0.0)
        return rho, u

    def fields_dense(self):
        """(rho, u) scattered back to the dense padded grid (numpy)."""
        rho, u = self.macroscopics()
        rho_d = untile(self.tiling, rho.cpu().numpy(), fill=np.nan)
        u_d = untile(self.tiling, u.cpu().numpy(), fill=0.0)
        return rho_d, u_d

    def total_mass(self) -> float:
        f_canon = self.backend.canonical(self.f)
        return float(f_canon.masked_fill(self._solid[None], 0.0).sum())

    # ------------------------------------------------------------ accounting
    @property
    def n_fluid_nodes(self) -> int:
        return self.tiling.n_fluid_nodes

    def bytes_per_step(self) -> int:
        """Eqn (10) minimum scaled by tile storage (incl. solid slots)."""
        stored = self.tiling.num_tiles * self.tiling.nodes_per_tile
        return 2 * self.lat.q * self.dtype.itemsize * stored

    def index_bytes_per_step(self) -> int:
        """Indirection-table bytes the step loads besides f itself.

        gather backend: the (Q, T, n) int32 table, or the compact split
        tables under ``split_stream``.  fused backend: the (T, 27)
        neighbour table plus the static (Q, n) pull perms/cases.
        """
        q, n = self.lat.q, self.tiling.nodes_per_tile
        t = self.tiling.num_tiles
        if self.cfg.backend == "fused":
            return 27 * t * 4 + q * n * 4 + q * n * 1
        if self.cfg.split_stream:
            return self.tables.split.index_bytes
        return q * t * n * 4

    def mflups(self, seconds_per_step: float) -> float:
        return self.n_fluid_nodes / seconds_per_step / 1e6

    def model_metrics(self) -> dict[str, float]:
        """Modelled per-step quantities under the reference's canonical
        metric names; computed from host tables only."""
        q, nf = self.lat.q, self.n_fluid_nodes
        min_bytes = 2 * q * nf * self.dtype.itemsize     # paper Eqn (10)
        idx = self.index_bytes_per_step()
        actual = self.bytes_per_step() + idx
        t = self.tables
        return {
            "lbm.bw.eqn10_min_bytes": float(min_bytes),
            "lbm.bw.eqn10_fraction": min_bytes / max(1, actual),
            "lbm.bytes.model_per_node": actual / max(1, nf),
            "lbm.index.bytes_per_node": idx / max(1, nf),
            "lbm.stream.interior_frac": float(t.interior_frac),
            "lbm.stream.frontier_frac": float(t.frontier_frac),
            "lbm.stream.bounce_frac": float(t.bounce_frac),
            "lbm.tiles.utilisation": float(self.tiling.tile_utilisation),
        }
