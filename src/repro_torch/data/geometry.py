"""Geometry generators for the paper's test cases (all synthetic, seeded).

A numpy copy of the generators that ``repro.launch.lbm.make_case`` reaches,
kept here so that the port never imports the JAX package.  Node-type
conventions come from ``repro_torch.core.tiling``:
SOLID=0, FLUID=1, INLET=2, OUTLET=3; additional values are free for custom
boundary types (e.g. the moving lid of cavity3D uses 4).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tiling import FLUID, INLET, OUTLET, SOLID

LID = 4  # moving-wall node type used by cavity3d


def cavity3d(b: int) -> np.ndarray:
    """Lid-driven cavity, b^3 FLUID nodes; the top z layer is the moving lid.

    The paper's dense test case: every node in the box is non-solid (walls
    live outside the domain via out-of-bounds bounce-back), so porosity = 1.
    """
    g = np.full((b, b, b), FLUID, dtype=np.uint8)
    g[:, :, -1] = LID
    return g


def _open_z_ends(inner: np.ndarray) -> None:
    """Mark fluid nodes on the first/last z plane as INLET/OUTLET (in place)."""
    inner[:, :, 0] = np.where(inner[:, :, 0] == FLUID, INLET, inner[:, :, 0])
    inner[:, :, -1] = np.where(inner[:, :, -1] == FLUID, OUTLET,
                               inner[:, :, -1])


def duct(nx: int, ny: int, nz: int, open_ends: bool = True) -> np.ndarray:
    """Rectangular duct along z: solid side walls, inlet at z=0, outlet z=-1."""
    g = np.full((nx, ny, nz), FLUID, dtype=np.uint8)
    g[0, :, :] = SOLID
    g[-1, :, :] = SOLID
    g[:, 0, :] = SOLID
    g[:, -1, :] = SOLID
    if open_ends:
        _open_z_ends(g[1:-1, 1:-1, :])
    return g


def duct_wrap(g: np.ndarray, wall: int = 1) -> np.ndarray:
    """Wrap a porous block in a solid duct: ``wall`` solid layers on the
    x/y faces, and open z faces (fluid nodes on the first/last z plane
    become INLET/OUTLET).  Turns e.g. ``random_spheres`` output into a
    well-posed flow-through case instead of a wall-less periodic box."""
    assert wall >= 1, "duct_wrap needs at least one wall layer"
    nx, ny, nz = g.shape
    out = np.full((nx + 2 * wall, ny + 2 * wall, nz), SOLID, dtype=np.uint8)
    out[wall:-wall, wall:-wall, :] = g
    _open_z_ends(out[wall:-wall, wall:-wall, :])
    return out


def channel2d(nx: int, ny: int) -> np.ndarray:
    """2-D Poiseuille channel (D2Q9): walls at y=0 / y=-1, periodic in x."""
    g = np.full((nx, ny, 1), FLUID, dtype=np.uint8)
    g[:, 0, :] = SOLID
    g[:, -1, :] = SOLID
    return g


def open_channel3d(nx: int, ny: int, nz: int) -> np.ndarray:
    """All-fluid box (periodic streaming handled by engine config)."""
    return np.full((nx, ny, nz), FLUID, dtype=np.uint8)


def random_spheres(
    box: int = 192,
    porosity: float = 0.5,
    diameter: int = 40,
    seed: int = 0,
    max_iter: int = 20000,
) -> np.ndarray:
    """Array of randomly arranged solid spheres (paper Table 6).

    Spheres (diameter in lattice units) are dropped at random centres
    (overlaps allowed) until the target porosity — non-solid fraction of the
    bounding box — is reached.
    """
    rng = np.random.default_rng(seed)
    g = np.full((box, box, box), FLUID, dtype=np.uint8)
    r = diameter / 2.0
    target_solid = (1.0 - porosity) * box ** 3
    xs = np.arange(box)
    solid_count = 0
    for _ in range(max_iter):
        if solid_count >= target_solid:
            break
        c = rng.uniform(r * 0.2, box - r * 0.2, size=3)
        lo = np.maximum(np.floor(c - r).astype(int), 0)
        hi = np.minimum(np.ceil(c + r).astype(int) + 1, box)
        sub = np.ix_(xs[lo[0]:hi[0]], xs[lo[1]:hi[1]], xs[lo[2]:hi[2]])
        dx = xs[lo[0]:hi[0], None, None] - c[0]
        dy = xs[None, lo[1]:hi[1], None] - c[1]
        dz = xs[None, None, lo[2]:hi[2]] - c[2]
        inside = dx * dx + dy * dy + dz * dz <= r * r
        newly = inside & (g[sub] != SOLID)
        solid_count += int(newly.sum())
        g[sub] = np.where(inside, SOLID, g[sub])
    return g


def _tube(g: np.ndarray, pts: np.ndarray, radii: np.ndarray) -> None:
    """Carve a tube of varying radius through solid block ``g`` (in place)."""
    nx, ny, nz = g.shape
    xs = np.arange(nx)[:, None, None]
    ys = np.arange(ny)[None, :, None]
    zs = np.arange(nz)[None, None, :]
    for (cx, cy, cz), r in zip(pts, radii):
        lo = np.maximum(np.floor([cx - r, cy - r, cz - r]).astype(int), 0)
        hi = np.minimum(np.ceil([cx + r, cy + r, cz + r]).astype(int) + 1, g.shape)
        sl = (slice(lo[0], hi[0]), slice(lo[1], hi[1]), slice(lo[2], hi[2]))
        d2 = (
            (xs[sl[0]] - cx) ** 2
            + (ys[:, sl[1]] - cy) ** 2
            + (zs[:, :, sl[2]] - cz) ** 2
        )
        g[sl] = np.where(d2 <= r * r, FLUID, g[sl])


def vessel_aneurysm(
    shape: tuple[int, int, int] = (128, 96, 96),
    radius: float = 10.0,
    bulge: float = 22.0,
    seed: int = 0,
) -> np.ndarray:
    """Synthetic cerebral-aneurysm-like geometry (paper Table 8 analogue):
    a curved vessel with a spherical bulge; good spatial locality, low
    porosity."""
    nx, ny, nz = shape
    g = np.full(shape, SOLID, dtype=np.uint8)
    t = np.linspace(0, 1, 160)
    cx = 8 + (nx - 16) * t
    cy = ny / 2 + 0.25 * ny * np.sin(2.2 * np.pi * t)
    cz = nz / 2 + 0.18 * nz * np.cos(1.7 * np.pi * t)
    pts = np.stack([cx, cy, cz], axis=1)
    radii = np.full(len(t), radius)
    _tube(g, pts, radii)
    # spherical bulge (the aneurysm) near the middle of the vessel
    mid = pts[len(t) // 2] + np.array([0.0, radius + bulge * 0.5, 0.0])
    _tube(g, mid[None, :], np.array([bulge]))
    # open the ends along x; BOTH end-adjacent planes carry the same
    # clamp so the inlet and outlet rims stay symmetric by construction
    # (a guard, not a behaviour change today: the carve above only writes
    # FLUID into SOLID, so non-fluid cells on these planes are already
    # SOLID — the clamp keeps that true if carving ever grows node types)
    fluid0 = g[1, :, :] == FLUID
    g[0, :, :] = np.where(fluid0, INLET, SOLID)
    g[1, :, :] = np.where(fluid0, g[1, :, :], SOLID)
    fl = g[-2, :, :] == FLUID
    g[-1, :, :] = np.where(fl, OUTLET, SOLID)
    g[-2, :, :] = np.where(fl, g[-2, :, :], SOLID)
    return g


def aorta_coarctation(
    shape: tuple[int, int, int] = (64, 96, 192),
    radius: float = 12.0,
    pinch: float = 0.45,
) -> np.ndarray:
    """Synthetic aorta-with-coarctation (paper Table 9 analogue): a gently
    arched tube along z whose radius pinches to ``pinch`` of nominal at the
    coarctation."""
    nx, ny, nz = shape
    g = np.full(shape, SOLID, dtype=np.uint8)
    t = np.linspace(0, 1, 220)
    cz = 4 + (nz - 8) * t
    cx = nx / 2 + 0.15 * nx * np.sin(np.pi * t)
    cy = ny / 2 + 0.25 * ny * np.sin(0.5 * np.pi * t)
    r = radius * (1.0 - (1.0 - pinch) * np.exp(-((t - 0.55) ** 2) / 0.004))
    pts = np.stack([cx, cy, cz], axis=1)
    _tube(g, pts, r)
    fluid0 = g[:, :, 1] == FLUID
    g[:, :, 0] = np.where(fluid0, INLET, SOLID)
    fl = g[:, :, -2] == FLUID
    g[:, :, -1] = np.where(fl, OUTLET, SOLID)
    return g
