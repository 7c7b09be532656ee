"""The plain reference: D3Q19 LBGK or LBMRT, incompressible or
quasi-compressible, on the non-solid nodes of the dense grid, in plain
PyTorch.

It works from the dense node-type grid and a configuration's physics
alone.  The nodes are the grid's non-solid points in C order; one step is

    pull streaming   f_in[q](x) = f[q](x - e_q), or f[opp q](x) (half-way
                     bounce-back) where x - e_q is solid or off a
                     non-periodic face; periodic axes wrap;
    open boundaries  non-equilibrium bounce-back (Zou-He velocity inlet,
                     constant-pressure outlet) on the nodes of each
                     boundary type, rebuilding the populations that
                     stream in from outside the fluid;
    collision        LBGK, f + (feq - f) / tau (Eqn 2), or LBMRT,
                     f + M^-1 S M (feq - f) (Eqn 8), with feq of rho and
                     the velocity u shifted by the body force F:
      incompressible       u = j, u + tau F,
                           feq = w (rho + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u)
                           (Eqn 4);
      quasi-compressible   u = j / rho, u + tau F / rho,
                           feq = w rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u)
                           (Eqn 3);

the paper's Eqns (2)-(8) and §2.2.  LBMRT's moments M are the 19
polynomials of d'Humieres, Ginzburg, Krafczyk, Lallemand & Luo, "Multiple-
relaxation-time lattice Boltzmann models in three dimensions", Phil. Trans.
R. Soc. A 360:437 (2002), and S holds that paper's rates: s1 1.19, s2 =
s10 = s12 1.4, s4 = s6 = s8 1.2, s16-18 1.98, s9 = s11 = s13 = s14 = s15 =
1/tau (they set the viscosity), 0 for the conserved rho and j.  The open
boundaries are rebuilt alike in both fluid models.  It imports nothing of
the program.
"""
from __future__ import annotations

import numpy as np
import torch

SOLID = 0
COLLISIONS = ("lbgk", "lbmrt")
FLUIDS = ("incompressible", "quasi_compressible")

# D3Q19 in the paper's direction order (Fig. 1): O, E N W S T B, NE NW SW
# SE, ET NT WT ST, EB NB WB SB
E = np.array([(0, 0, 0),
              (1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
              (1, 1, 0), (-1, 1, 0), (-1, -1, 0), (1, -1, 0),
              (1, 0, 1), (0, 1, 1), (-1, 0, 1), (0, -1, 1),
              (1, 0, -1), (0, 1, -1), (-1, 0, -1), (0, -1, -1)], np.int64)
W = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12, np.float64)
OPP = np.array([int(np.nonzero((E == -e).all(axis=1))[0][0]) for e in E], np.int64)
Q = len(E)


def equilibrium(rho: torch.Tensor, u: torch.Tensor, e: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """feq (Q, N) of rho (N,) and u (3, N), incompressible (Eqn 4), for the
    directions ``e`` (Q, 3) and weights ``w`` (Q,) in the state's type."""
    eu = e @ u
    u2 = (u * u).sum(dim=0)
    return eu.mul(4.5).add_(3.0).mul_(eu).add_(rho - 1.5 * u2).mul_(w[:, None])


def quasi_equilibrium(rho: torch.Tensor, u: torch.Tensor, e: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """feq (Q, N) of rho (N,) and u (3, N), quasi-compressible (Eqn 3)."""
    eu = e @ u
    u2 = (u * u).sum(dim=0)
    return eu.mul(4.5).add_(3.0).mul_(eu).add_(1.0 - 1.5 * u2).mul_(rho).mul_(w[:, None])


def moment_matrix() -> np.ndarray:
    """d'Humieres et al. (2002)'s (19, Q) moment matrix M in this module's
    direction order: the rows rho, e, eps, jx, qx, jy, qy, jz, qz, 3pxx,
    3pixx, pww, piww, pxy, pyz, pxz, mx, my, mz as polynomials of e."""
    x, y, z = E.T.astype(np.float64)
    c2 = x * x + y * y + z * z
    return np.stack([
        np.ones(Q), 19 * c2 - 30, (21 * c2 * c2 - 53 * c2 + 24) / 2,
        x, (5 * c2 - 9) * x, y, (5 * c2 - 9) * y, z, (5 * c2 - 9) * z,
        3 * x * x - c2, (3 * c2 - 5) * (3 * x * x - c2),
        y * y - z * z, (3 * c2 - 5) * (y * y - z * z),
        x * y, y * z, x * z,
        x * (y * y - z * z), y * (z * z - x * x), z * (x * x - y * y)])


def mrt_rates(tau: float) -> np.ndarray:
    """The (19,) relaxation rates of the moments of ``moment_matrix``."""
    s = np.zeros(Q)
    s[1], s[[2, 10, 12]], s[[4, 6, 8]], s[16:] = 1.19, 1.4, 1.2, 1.98
    s[[9, 11, 13, 14, 15]] = 1.0 / tau
    return s


def fluid_nodes(g: torch.Tensor):
    """The non-solid nodes of the dense node-type grid ``g``: their
    coordinates (N, 3) int64 in C order, and the grid of their numbers
    (X, Y, Z) int64, -1 at solid nodes."""
    fluid = g != SOLID
    coords = torch.nonzero(fluid)
    index = torch.full(g.shape, -1, dtype=torch.int64, device=g.device)
    index[fluid] = torch.arange(len(coords), device=g.device)
    return coords, index


class Reference:
    """The reference solver over one geometry, on ``device`` in ``dtype``.

    geometry:   dense (X, Y, Z) uint8 node types (SOLID = 0)
    physics:    a configuration's ``physics`` entry: ``collision``
                (``COLLISIONS``), ``fluid`` (``FLUIDS``), ``tau``,
                ``force`` (None or (3,)), ``periodic`` ((3,) bools) and
                ``boundaries`` (list of {node_type, kind, normal,
                velocity | rho})
    """

    def __init__(self, geometry: np.ndarray, physics: dict, device,
                 dtype: torch.dtype = torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.shape = tuple(int(s) for s in geometry.shape)
        self.tau = float(physics["tau"])
        self.collision, fluid = physics["collision"], physics["fluid"]
        if self.collision not in COLLISIONS or fluid not in FLUIDS:
            raise ValueError(f"no reference for collision {self.collision!r}, fluid {fluid!r}")
        self.quasi = fluid == "quasi_compressible"
        periodic = tuple(bool(p) for p in physics["periodic"])
        g = torch.as_tensor(np.ascontiguousarray(geometry), device=self.device)
        self.coords, index = fluid_nodes(g)
        self.index = index
        n = self.n = len(self.coords)
        # one flat gather index a direction: the source node's slot in the
        # flattened (Q, N) state, or the node's own opposite population
        own = torch.arange(n, device=self.device)
        dims = torch.tensor(self.shape, device=self.device)
        src = torch.empty((Q, n), dtype=torch.int64, device=self.device)
        for q in range(Q):
            s = self.coords - torch.as_tensor(E[q], device=self.device)
            ok = torch.ones(n, dtype=torch.bool, device=self.device)
            for ax in range(3):
                if periodic[ax]:
                    s[:, ax] %= dims[ax]
                else:
                    ok &= (s[:, ax] >= 0) & (s[:, ax] < dims[ax])
            s = torch.minimum(torch.clamp(s, min=0), dims - 1)
            nb = torch.where(ok, index[s[:, 0], s[:, 1], s[:, 2]], -1)
            src[q] = torch.where(nb >= 0, q * n + nb, int(OPP[q]) * n + own)
        self.src = src.reshape(-1)
        kw = dict(dtype=dtype, device=self.device)
        self._e = torch.as_tensor(E, **kw)
        self._w = torch.as_tensor(W, **kw)
        # rows of the moments: rho = sum f, j = sum e f
        self._moments = torch.cat([torch.ones((1, Q), **kw), self._e.T])
        if self.collision == "lbmrt":
            m = moment_matrix()
            # M's rows are orthogonal: M^-1 = M^T diag(1 / |row|^2)
            self._mrt = tuple(torch.as_tensor(a, **kw) for a in
                              (m.T / (m * m).sum(axis=1), np.diag(mrt_rates(self.tau)), m))
        force = physics.get("force")
        self._force = None if force is None else self.tau * torch.as_tensor(force, **kw)[:, None]
        self.boundaries = []
        for bc in physics.get("boundaries", ()):
            normal = np.asarray(bc["normal"], np.int64)
            en = E @ normal
            unknown = np.nonzero(en > 0)[0]
            sets = [torch.as_tensor(v, device=self.device) for v in
                    (unknown, OPP[unknown], np.nonzero(en < 0)[0], np.nonzero(en == 0)[0])]
            if bc["kind"] == "velocity":
                u = np.asarray(bc["velocity"], np.float64)
                known_to_rho = 1.0 / (1.0 - float(u @ normal))
                # 2 w_i rho (e_i . u) / cs^2 for the unknown directions, per unit rho
                push = torch.as_tensor(6.0 * W[unknown] * (E[unknown] @ u), **kw)
            else:
                known_to_rho = None
                push = torch.as_tensor(6.0 * W[unknown] * (E[unknown] @ normal), **kw)
            self.boundaries.append((index[g == int(bc["node_type"])], bc, sets,
                                    known_to_rho, push))

    # ------------------------------------------------------------ physics
    def equilibrium(self, rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return (quasi_equilibrium if self.quasi else equilibrium)(rho, u, self._e, self._w)

    def macroscopics(self, f: torch.Tensor):
        """rho (N,) and u (3, N) of f (Q, N): u = j, or j / rho in the
        quasi-compressible fluid."""
        m = self._moments @ f.to(self.dtype)
        return m[0], m[1:] / m[0] if self.quasi else m[1:]

    def _open_boundaries(self, f_in: torch.Tensor) -> None:
        """Non-equilibrium bounce-back on every boundary type, in place:
        f_i = f_opp(i) + 2 w_i rho (e_i . u) / cs^2 for each unknown i, with
        rho from the known populations and the set velocity (velocity
        inlet), or rho set and the normal velocity from mass conservation
        (pressure outlet)."""
        for nodes, bc, (unknown, opp, outgoing, parallel), known_to_rho, push in self.boundaries:
            if not len(nodes):
                continue
            fb = f_in[:, nodes]
            known = fb[parallel].sum(dim=0) + 2.0 * fb[outgoing].sum(dim=0)
            # rho (e_i . u): rho = known / (1 - u.n) with u set, or
            # rho (1 - known / rho) (e_i . n) = (rho - known) (e_i . n) with rho set
            scale = known * known_to_rho if known_to_rho is not None else float(bc["rho"]) - known
            f_in[unknown[:, None], nodes[None, :]] = fb[opp] + push[:, None] * scale[None]

    def step(self, f: torch.Tensor) -> torch.Tensor:
        """One LBM step of the (Q, N) state ``f``; returns the new state."""
        f_in = f.reshape(-1)[self.src].reshape(Q, self.n)
        self._open_boundaries(f_in)
        rho, u = self.macroscopics(f_in)
        if self._force is not None:
            u = u + (self._force / rho if self.quasi else self._force)
        if self.collision == "lbmrt":
            m_inv, s, m = self._mrt
            return f_in.add_(m_inv @ (s @ (m @ self.equilibrium(rho, u).sub_(f_in))))
        # LBGK: f + (feq - f) / tau = (1 - 1/tau) f + feq / tau
        out = self.equilibrium(rho, u).mul_(1.0 / self.tau)
        return out.add_(f_in, alpha=1.0 - 1.0 / self.tau)

    def run(self, f: torch.Tensor, steps: int) -> torch.Tensor:
        f = f.to(self.dtype)
        for _ in range(steps):
            f = self.step(f)
        return f


def seeded_state(n: int, device, seed: int, amp_rho: float, amp_u: float,
                 rho0: float = 1.0, u0=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """The float64 (Q, N) initial state of a run of ``n`` nodes: the
    equilibrium of a density and a velocity perturbed at every node,
    uniformly within ``amp_rho`` and ``amp_u`` of (rho0, u0), drawn from
    ``seed`` on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    rho = rho0 + amp_rho * (2.0 * torch.rand(n, generator=gen, **f64) - 1.0)
    u = (torch.as_tensor(u0, **f64)[:, None]
         + amp_u * (2.0 * torch.rand((3, n), generator=gen, **f64) - 1.0))
    return equilibrium(rho, u, torch.as_tensor(E, **f64), torch.as_tensor(W, **f64))
