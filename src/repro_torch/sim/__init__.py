"""repro_torch.sim — multi-tenant batched LBM simulation serving.

The port of ``repro.sim``; three layers, each usable on its own:

* :mod:`repro_torch.sim.registry` — engine registry: one
  :class:`~repro_torch.core.engine.SparseTiledLBM` (tiling, stream tables,
  device tables) per distinct ``(geometry fingerprint, LBMConfig
  signature)``, shared by every session on that geometry.
* :mod:`repro_torch.sim.ensemble` — :class:`EnsembleLBM`: B independent
  flow states over ONE geometry's tables, advanced together (on ``fused``
  one launch of K1 over B*T tiles per step).
* :mod:`repro_torch.sim.service` — :class:`SimService`: fixed-slot session
  manager (submit / step / collect) with per-session step budgets, probe
  readouts, and checkpoint/resume through
  :class:`repro_torch.checkpoint.store.CheckpointStore`.
"""
from .ensemble import EnsembleLBM
from .registry import EngineRegistry, config_signature, geometry_fingerprint
from .service import SimService, SimSession

__all__ = [
    "EnsembleLBM",
    "EngineRegistry",
    "SimService",
    "SimSession",
    "config_signature",
    "geometry_fingerprint",
]
