"""Collision operators — paper Eqns (2)-(8), on torch tensors.

The port of ``repro.core.collision``: both collision models (LBGK, LBMRT)
in both fluid models (incompressible, quasi-compressible).  Every function
takes ``f`` with the direction axis FIRST, (Q, ...), and works on any
trailing shape and on any device.

Like the reference, the quasi-compressible ``u = j / rho`` is unguarded:
solid slots (rho = 0) give NaN here and are masked by the caller.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .lattice import Lattice, d3q19_mrt_collision_matrix

INCOMPRESSIBLE = "incompressible"
QUASI_COMPRESSIBLE = "quasi_compressible"

LBGK = "lbgk"
LBMRT = "lbmrt"


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    model: str = LBGK                 # 'lbgk' | 'lbmrt'
    fluid: str = INCOMPRESSIBLE       # 'incompressible' | 'quasi_compressible'
    tau: float = 0.6

    def __post_init__(self):
        if self.model not in (LBGK, LBMRT):
            raise ValueError(f"unknown collision model {self.model!r}")
        if self.fluid not in (INCOMPRESSIBLE, QUASI_COMPRESSIBLE):
            raise ValueError(f"unknown fluid model {self.fluid!r}")
        if not self.tau > 0.5:
            raise ValueError("tau <= 0.5 is unstable (negative viscosity)")

    @property
    def viscosity(self) -> float:
        return (self.tau - 0.5) / 3.0

    def span_attrs(self) -> dict:
        """The attributes by which the engines' spans name this physics."""
        return {"collision": self.model, "fluid": self.fluid, "tau": self.tau}


# Constant tensors are cached per (dtype, device): a copy from pageable host
# memory synchronises the stream, which would stall every step on the card.
@lru_cache(maxsize=None)
def lattice_tensors(lat: Lattice, dtype: torch.dtype, device: torch.device):
    """(e (Q, 3), w (Q,)) of ``lat`` as tensors."""
    return (torch.as_tensor(lat.e.astype(np.float64), dtype=dtype, device=device),
            torch.as_tensor(lat.w, dtype=dtype, device=device))


@lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device):
    """A small constant vector as a tensor (force, velocity, normal)."""
    return torch.as_tensor(values, dtype=dtype, device=device)


@lru_cache(maxsize=None)
def collision_matrix(lat: Lattice, tau: float, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The (Q, Q) MRT matrix A = M^-1 S M as a tensor."""
    return torch.as_tensor(collision_matrix_np(lat, tau), dtype=dtype,
                           device=device).contiguous()


def macroscopics(f: torch.Tensor, lat: Lattice, fluid: str):
    """rho and u from f — Eqns (5) (quasi-compressible) / (6).

    f: (Q, ...) -> rho (...), u (3, ...)
    """
    rho = f.sum(dim=0)
    e, _ = lattice_tensors(lat, f.dtype, f.device)
    j = torch.tensordot(e.T, f, dims=1)                    # (3, ...)
    u = j / rho if fluid == QUASI_COMPRESSIBLE else j
    return rho, u


def equilibrium(rho: torch.Tensor, u: torch.Tensor, lat: Lattice, fluid: str):
    """Equilibrium distribution — Eqn (3) (quasi) / Eqn (4) (incompressible).

    rho: (...), u: (3, ...) -> feq (Q, ...)
    """
    e, w = lattice_tensors(lat, u.dtype, u.device)
    eu = torch.tensordot(e, u, dims=1)                     # (Q, ...)
    u2 = (u * u).sum(dim=0)
    # cs^2 = 1/3: 1/cs^2 = 3, 1/(2 cs^4) = 4.5, 1/(2 cs^2) = 1.5
    poly = 3.0 * eu + 4.5 * eu * eu - 1.5 * u2
    wq = w.reshape((lat.q,) + (1,) * (u.dim() - 1))
    if fluid == QUASI_COMPRESSIBLE:
        return wq * rho[None] * (1.0 + poly)
    return wq * (rho[None] + poly)


def collide(f: torch.Tensor, lat: Lattice, cfg: CollisionConfig, force=None):
    """One collision step (post-streaming f -> post-collision f).

    ``force`` is an optional (3,) body-force density, applied through the
    velocity shift u_eq = u + tau * F / rho.  Returns (f_out, rho, u) with
    rho/u the pre-forcing macroscopics.
    """
    rho, u = macroscopics(f, lat, cfg.fluid)
    u_eq = u
    if force is not None:
        fvec = constant(tuple(float(v) for v in force), f.dtype, f.device)
        fvec = fvec.reshape((3,) + (1,) * (u.dim() - 1))
        if cfg.fluid == QUASI_COMPRESSIBLE:
            u_eq = u + cfg.tau * fvec / rho[None]
        else:
            u_eq = u + cfg.tau * fvec
    feq = equilibrium(rho, u_eq, lat, cfg.fluid)
    if cfg.model == LBGK:
        f_out = f + (feq - f) / cfg.tau
    else:
        a = collision_matrix(lat, cfg.tau, f.dtype, f.device)
        f_out = f + torch.tensordot(a, feq - f, dims=1)
    return f_out, rho, u


@lru_cache(maxsize=None)
def collision_matrix_np(lat: Lattice, tau: float) -> np.ndarray:
    """A = M^-1 S M (paper Eqn 8) as a cached numpy constant."""
    if lat.q != 19:
        raise NotImplementedError("MRT matrix defined for D3Q19 only")
    return d3q19_mrt_collision_matrix(float(tau))


def model_flops_per_node(cfg: CollisionConfig, lat: Lattice) -> int:
    """Analytic FLOP count of one node's collision and macroscopics, counted
    from the formulas (the reference's ``model_flops_per_node``, a portable
    analogue of the paper's Table 2).  The work that K1 and K2 do a node,
    in their cost functions."""
    q, d = lat.q, 3
    nonzero_e = int((lat.e != 0).sum())
    flops = (q - 1)                       # rho = sum f
    flops += nonzero_e * 2 - d            # j: adds+mults for nonzero e only
    if cfg.fluid == QUASI_COMPRESSIBLE:
        flops += d                        # u = j / rho
    # equilibrium: eu (nonzero e), poly (4 ops), weight apply (2)
    flops += nonzero_e * 2 - q + q * 6 + (q if cfg.fluid == QUASI_COMPRESSIBLE else 0)
    flops += 3                            # u2
    if cfg.model == LBGK:
        flops += q * 3                    # (feq - f)/tau + f
    else:
        flops += q * q * 2 + q * 2        # dense 19x19 matvec + update
    return flops
