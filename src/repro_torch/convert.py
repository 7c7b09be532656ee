"""Carry the JAX package's configuration and flow state into the port and
back.

The reference's state is plain numpy once it leaves JAX, so nothing here
imports it:

* :func:`config_from_reference` takes the dict of the reference's
  ``repro.sim.registry.config_to_dict`` (``dataclasses.asdict`` of its
  ``LBMConfig``) and gives the port's :class:`LBMConfig`.
* :func:`state_from_reference` takes ``np.asarray(ref_engine.f)`` — the
  storage layout (Q, T, n) of a gather engine in its ``layout_scheme``
  order, or the packed (T+1, Q, n) state of a fused engine — and gives the
  port engine's state.  The reference engine must have run the same
  geometry and configuration (layout and orders included).
* :func:`state_to_reference` does the reverse.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.boundary import BoundarySpec
from .core.collision import CollisionConfig
from .core.engine import LBMConfig, SparseTiledLBM


def config_from_reference(d: dict) -> LBMConfig:
    """The port's LBMConfig from a reference ``config_to_dict`` dict.

    ``kernel_interpret`` (Pallas interpret mode) has no counterpart and is
    dropped.
    """
    d = {k: v for k, v in d.items() if k != "kernel_interpret"}
    d["collision"] = CollisionConfig(**d["collision"])
    d["boundaries"] = tuple(
        (int(tv), BoundarySpec(kind=s["kind"], normal=tuple(s["normal"]),
                               velocity=tuple(s["velocity"]),
                               rho=float(s["rho"])))
        for tv, s in d["boundaries"])
    d["periodic"] = tuple(bool(p) for p in d["periodic"])
    d["u0"] = tuple(float(v) for v in d["u0"])
    if d.get("force") is not None:
        d["force"] = tuple(float(v) for v in d["force"])
    return LBMConfig(**d)


def _packed_shape(engine: SparseTiledLBM):
    t, n = engine.tiling.num_tiles, engine.tiling.nodes_per_tile
    return (t + 1, engine.lat.q, n), (engine.lat.q, t, n)


def state_from_reference(f_np: np.ndarray, engine: SparseTiledLBM) -> torch.Tensor:
    """The port state for ``engine`` from a reference engine's ``f``.

    A packed (T+1, Q, n) array is a fused engine's state; a (Q, T, n) array
    a gather engine's storage layout.  Either converts into either backend
    (through the canonical (Q, T, n) order) and becomes the engine's new
    state buffer: assign the result to ``engine.f``.
    """
    f = torch.tensor(np.asarray(f_np), dtype=engine.dtype,
                     device=engine.device)
    packed, storage = _packed_shape(engine)
    if tuple(f.shape) == packed:
        canon = f[:-1].movedim(0, 1)
    elif tuple(f.shape) == storage:
        # a gather engine's storage layout is this config's layout_scheme
        canon = (engine.backend.canonical(f) if engine.cfg.backend == "gather"
                 else f)
    else:
        raise ValueError(f"state shape {tuple(f.shape)} is neither packed "
                         f"{packed} nor storage {storage}")
    return engine.backend.initial_state(canon.contiguous())


def state_to_reference(engine: SparseTiledLBM) -> np.ndarray:
    """``engine.f`` as numpy in the layout of a reference engine with the
    same configuration: packed (T+1, Q, n) for fused, storage (Q, T, n) for
    gather."""
    return engine.f.detach().cpu().numpy()
