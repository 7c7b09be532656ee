"""Dense (non-tiled) LBM engine — the roll-based oracle.

The port of ``repro.core.dense``: the classic full-array implementation the
paper measures against, with ``torch.roll`` streaming and half-way
bounce-back.  It shares collision and boundary code with the sparse engine,
so the two agree to rounding — the equivalence oracle for the tiled data
path.  Runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import collision as col
from .boundary import apply_open_boundary
from .engine import DTYPES, LBMConfig
from .lattice import get_lattice
from .tiling import SOLID


class DenseLBM:
    def __init__(self, node_type: np.ndarray, cfg: LBMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lat = get_lattice(cfg.lattice)
        self.node_type = np.ascontiguousarray(node_type.astype(np.uint8))
        self.dtype = DTYPES[cfg.dtype]
        self._solid = torch.as_tensor(self.node_type == SOLID, device=self.device)
        self._bc_masks = [
            (torch.as_tensor(self.node_type == tv, device=self.device), spec)
            for tv, spec in cfg.boundaries]
        # per direction: where the pull source is solid or out of the domain
        self._bounce = [self._roll(self._solid, q) | self._oob_mask(self.lat.e[q])
                        for q in range(self.lat.q)]
        self.f = self._initial_state()

    def _initial_state(self) -> torch.Tensor:
        shape = self.node_type.shape
        kw = dict(dtype=self.dtype, device=self.device)
        rho = torch.full(shape, self.cfg.rho0, **kw)
        u = torch.as_tensor(self.cfg.u0, **kw).reshape(3, 1, 1, 1).expand((3,) + shape)
        feq = col.equilibrium(rho, u, self.lat, self.cfg.collision.fluid)
        return feq.masked_fill(self._solid[None], 0.0)

    def _roll(self, x: torch.Tensor, q: int) -> torch.Tensor:
        return torch.roll(x, shifts=tuple(int(v) for v in self.lat.e[q]),
                          dims=(0, 1, 2))

    def _oob_mask(self, e) -> torch.Tensor:
        """True where the pull source lies outside a non-periodic domain."""
        shape = self.node_type.shape
        out = torch.zeros(shape, dtype=torch.bool, device=self.device)
        for ax in range(3):
            if self.cfg.periodic[ax] or e[ax] == 0:
                continue
            idx = torch.arange(shape[ax], device=self.device)
            k = int(e[ax])
            m1 = idx < k if k > 0 else idx >= shape[ax] + k
            shape_b = [1, 1, 1]
            shape_b[ax] = shape[ax]
            out = out | m1.reshape(shape_b)
        return out

    def _stream(self, f: torch.Tensor) -> torch.Tensor:
        """Pull streaming with half-way bounce-back via ``torch.roll``."""
        opp = self.lat.opp
        return torch.stack([torch.where(self._bounce[q], f[int(opp[q])],
                                        self._roll(f[q], q))
                            for q in range(self.lat.q)])

    def _step(self, f: torch.Tensor) -> torch.Tensor:
        f_in = self._stream(f)
        for mask, spec in self._bc_masks:
            f_in = apply_open_boundary(f_in, mask, spec, self.lat)
        f_out, _, _ = col.collide(f_in, self.lat, self.cfg.collision, self.cfg.force)
        return f_out.masked_fill(self._solid[None], 0.0)

    def step(self, steps: int = 1) -> None:
        for _ in range(steps):
            self.f = self._step(self.f)

    def macroscopics(self):
        rho, u = col.macroscopics(self.f, self.lat, self.cfg.collision.fluid)
        rho = torch.where(self._solid, torch.full_like(rho, self.cfg.rho0), rho)
        return rho, u.masked_fill(self._solid[None], 0.0)

    def total_mass(self) -> float:
        return float(self.f.masked_fill(self._solid[None], 0.0).sum())

    @property
    def n_fluid_nodes(self) -> int:
        return int((self.node_type != SOLID).sum())
