"""Engine registry: one engine per (geometry, config) key.

The port of ``repro.sim.registry``.  Building an engine costs the host-side
tiler and stream tables (megabytes of numpy) and the backend's device
tables; concurrent sessions on the SAME geometry must not pay it per
session.  The registry canonicalises ``(node_type hash, LBMConfig
signature)`` into one :class:`EngineEntry` whose tiling, tables and backend
every session shares.  Live flow state is NOT cached here — each consumer
builds its own :class:`~repro_torch.sim.ensemble.EnsembleLBM` from the
shared engine, so two services sharing a registry can never step each
other's tenants.

The config dict is the reference's (``dataclasses.asdict`` of the config,
with the reference's ``kernel_interpret`` field set to None: interpret mode
chosen by the reference's platform), so session manifests written by
either package load in the other; :func:`config_from_dict` drops
``kernel_interpret`` (Pallas interpret mode), which the port has no use
for.  The signature hashes the
port's own dict, so it differs from the reference's: a restored session
recomputes it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from ..convert import config_from_reference
from ..core.engine import LBMConfig, SparseTiledLBM
from ..device import resolve_device


def geometry_fingerprint(node_type: np.ndarray) -> str:
    """Content hash of a dense uint8 node-type array (shape included)."""
    g = np.ascontiguousarray(np.asarray(node_type, np.uint8))
    h = hashlib.sha1()
    h.update(repr(g.shape).encode())
    h.update(g.tobytes())
    return h.hexdigest()[:16]


def config_to_dict(cfg: LBMConfig) -> dict:
    """LBMConfig -> the reference's JSON-serialisable dict (nested
    dataclasses flattened, ``kernel_interpret`` None); inverse of
    :func:`config_from_dict`."""
    return dict(dataclasses.asdict(cfg), kernel_interpret=None)


# the inverse of config_to_dict, for the port's dicts and the reference's
# alike (lists re-tupled, nested dataclasses re-hydrated, kernel_interpret
# dropped)
config_from_dict = config_from_reference


def config_signature(cfg: LBMConfig) -> str:
    """Stable hash of the full config tree."""
    blob = json.dumps(config_to_dict(cfg), sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class EngineEntry:
    """One built geometry+config: the shared (immutable) engine tables.

    The entry holds NO flow state: every consumer builds its own ensemble
    via ``entry.engine.ensemble(batch)``.
    """

    key: tuple[str, str]                     # (geometry fp, config sig)
    engine: SparseTiledLBM
    # sessions seated on this entry — recorded by consumers (SimService
    # bumps once per seat); get() itself never counts
    hits: int = 0


class EngineRegistry:
    """Engines on ``device`` (None: the card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._entries: dict[tuple[str, str], EngineEntry] = {}

    def key_for(self, node_type: np.ndarray,
                cfg: LBMConfig) -> tuple[str, str]:
        return (geometry_fingerprint(node_type), config_signature(cfg))

    def get(self, node_type: np.ndarray, cfg: LBMConfig) -> EngineEntry:
        """The entry for (geometry, config) — built on first miss.  Pure
        lookup: callers that SEAT a session record the hit themselves."""
        key = self.key_for(node_type, cfg)
        entry = self._entries.get(key)
        if entry is None:
            entry = EngineEntry(key=key, engine=SparseTiledLBM(
                np.asarray(node_type), cfg, device=self.device))
            self._entries[key] = entry
        return entry

    @property
    def compiled_count(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        """JSON-ready registry summary (surfaced by launch/sim_serve.py)."""
        return {
            "compiled_engines": self.compiled_count,
            "hits": sum(e.hits for e in self._entries.values()),
            "entries": [
                {"geometry": k[0], "config": k[1], "hits": e.hits,
                 "num_tiles": e.engine.tiling.num_tiles,
                 "n_fluid_nodes": e.engine.n_fluid_nodes}
                for k, e in self._entries.items()
            ],
        }
