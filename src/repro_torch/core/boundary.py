"""Open boundary conditions (paper §2.2), on torch tensors.

The port of ``repro.core.boundary``.  Walls need no code here: half-way
bounce-back is folded into streaming.  Inlets are Zou-He-type velocity
boundaries and outlets constant-pressure boundaries, both rebuilt by
non-equilibrium bounce-back (NEBB): after streaming, each unknown incoming
population becomes

    f_i = f_opp(i) + 2 w_i rho (e_i . u) / cs^2

with rho from the known populations (velocity BC), or rho := rho_bc and the
normal velocity solved from mass conservation (pressure BC).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .collision import constant, lattice_tensors
from .lattice import Lattice


@dataclasses.dataclass(frozen=True)
class BoundarySpec:
    """An axis-aligned open boundary.

    normal: unit int vector pointing INTO the fluid, e.g. (0, 0, 1) for an
    inlet at the low-z face.
    """

    kind: str                       # 'velocity' | 'pressure'
    normal: tuple[int, int, int]
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    rho: float = 1.0


def _direction_sets(lat: Lattice, normal):
    edotn = lat.e @ np.asarray(normal)
    return (np.nonzero(edotn > 0)[0],     # unknown (to reconstruct)
            np.nonzero(edotn < 0)[0],     # outgoing
            np.nonzero(edotn == 0)[0])    # parallel


@lru_cache(maxsize=None)
def _index_tensors(lat: Lattice, normal: tuple, device: torch.device):
    """(unknown, opp(unknown), outgoing, parallel) direction indices on
    ``device``."""
    unknown, outgoing, parallel = _direction_sets(lat, normal)
    return tuple(torch.as_tensor(v, device=device)
                 for v in (unknown, lat.opp[unknown], outgoing, parallel))


def apply_open_boundary(f: torch.Tensor, mask: torch.Tensor,
                        spec: BoundarySpec, lat: Lattice) -> torch.Tensor:
    """Rebuild unknown populations on nodes selected by ``mask``.

    f: (Q, ...), mask: (...) bool.  Returns a new f.  All unknown
    directions are rebuilt in one batch of ops (each op is a launch on the
    card, and the fused step runs this pass every step).
    """
    unknown, opp, outgoing, parallel = _index_tensors(lat, tuple(spec.normal),
                                                      f.device)
    n = constant(tuple(float(v) for v in spec.normal), f.dtype, f.device)

    f_par = f[parallel].sum(dim=0)
    f_out = f[outgoing].sum(dim=0)

    lead = (3,) + (1,) * mask.dim()
    if spec.kind == "velocity":
        u = constant(tuple(float(v) for v in spec.velocity), f.dtype, f.device)
        un = torch.dot(u, n)
        rho = (f_par + 2.0 * f_out) / (1.0 - un)
        u_full = u.reshape(lead).expand((3,) + tuple(mask.shape))
    elif spec.kind == "pressure":
        rho = constant((float(spec.rho),), f.dtype, f.device)[0]
        # mass conservation normal to the face: rho (1 - u.n) = f_par + 2 f_out
        un = 1.0 - (f_par + 2.0 * f_out) / rho
        u_full = un[None] * n.reshape(lead).expand((3,) + tuple(mask.shape))
    else:
        raise ValueError(spec.kind)

    e, w = lattice_tensors(lat, f.dtype, f.device)
    eu = torch.tensordot(e[unknown], u_full, dims=1)          # (U, ...)
    w_u = w[unknown].reshape((-1,) + (1,) * mask.dim())
    rebuilt = f[opp] + 2.0 * w_u * rho * eu * 3.0
    new_f = f.clone()
    new_f[unknown] = torch.where(mask, rebuilt, f[unknown])
    return new_f
