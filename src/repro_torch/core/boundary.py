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


def _total(terms, zero: torch.Tensor) -> torch.Tensor:
    """``zero`` plus the signed terms ``(sign, tensor)``, one add at a time
    in the given order (as ``csrc/nebb_pass.cu`` sums)."""
    acc = zero
    for sign, v in terms:
        acc = acc + v if sign > 0 else acc - v
    return acc


def apply_open_boundary(f: torch.Tensor, mask: torch.Tensor,
                        spec: BoundarySpec, lat: Lattice) -> torch.Tensor:
    """Rebuild unknown populations on nodes selected by ``mask``.

    f: (Q, ...), mask: (...) bool.  Returns a new f.  Every op is
    elementwise (the sums over directions are written out), so a node's
    result does not depend on how many nodes ``f`` holds, as the rounding
    of a reduction or a matmul over them would.
    """
    nrm = np.asarray(spec.normal)
    en = lat.e @ nrm
    zero = f.new_zeros(())
    f_par = _total([(1, f[i]) for i in np.nonzero(en == 0)[0]], zero)
    f_out = _total([(1, f[i]) for i in np.nonzero(en < 0)[0]], zero)
    if spec.kind == "velocity":
        u = constant(tuple(float(v) for v in spec.velocity), f.dtype, f.device)
        un = _total([(c, u[a]) for a, c in enumerate(nrm) if c], zero)
        rho = (f_par + 2.0 * f_out) / (1.0 - un)
        u = u.unbind(0)
    elif spec.kind == "pressure":
        rho = constant((float(spec.rho),), f.dtype, f.device)[0]
        # mass conservation normal to the face: rho (1 - u.n) = f_par + 2 f_out
        un = 1.0 - (f_par + 2.0 * f_out) / rho
        u = [un if c > 0 else (-un if c < 0 else zero) for c in nrm]
    else:
        raise ValueError(spec.kind)

    _, w = lattice_tensors(lat, f.dtype, f.device)
    new_f = list(f.unbind(0))
    for i in np.nonzero(en > 0)[0]:
        eu = _total([(c, u[a]) for a, c in enumerate(lat.e[i]) if c], zero)
        rebuilt = f[lat.opp[i]] + 2.0 * w[i] * rho * eu * 3.0
        new_f[i] = torch.where(mask, rebuilt, f[i])
    return torch.stack(new_f)
