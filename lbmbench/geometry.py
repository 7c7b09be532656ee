"""The benchmark's own geometry generators (numpy), frozen.

A copy of the two generators of ``repro_torch.data.geometry`` that the
benchmark's configurations name, kept here so that a change to the program
cannot change the geometry it is measured on.  Node types: SOLID 0,
FLUID 1, INLET 2, OUTLET 3.
"""
from __future__ import annotations

import numpy as np

SOLID, FLUID, INLET, OUTLET = 0, 1, 2, 3


def random_spheres(box: int, porosity: float, diameter: int, seed: int,
                   max_iter: int = 20000) -> np.ndarray:
    """A random sphere pack (paper Table 6): solid spheres of ``diameter``
    dropped at random centres (overlaps allowed) until the non-solid share
    of the ``box``^3 grid falls to ``porosity``."""
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
    """Carve a tube of varying radius through the solid block ``g``."""
    nx, ny, nz = g.shape
    xs = np.arange(nx)[:, None, None]
    ys = np.arange(ny)[None, :, None]
    zs = np.arange(nz)[None, None, :]
    for (cx, cy, cz), r in zip(pts, radii):
        lo = np.maximum(np.floor([cx - r, cy - r, cz - r]).astype(int), 0)
        hi = np.minimum(np.ceil([cx + r, cy + r, cz + r]).astype(int) + 1, g.shape)
        sl = (slice(lo[0], hi[0]), slice(lo[1], hi[1]), slice(lo[2], hi[2]))
        d2 = ((xs[sl[0]] - cx) ** 2 + (ys[:, sl[1]] - cy) ** 2
              + (zs[:, :, sl[2]] - cz) ** 2)
        g[sl] = np.where(d2 <= r * r, FLUID, g[sl])


def vessel_aneurysm(shape, radius: float, bulge: float) -> np.ndarray:
    """A cerebral-aneurysm-like vessel (paper Table 8 analogue): a curved
    tube along x with a spherical bulge at its middle, an INLET plane at
    x = 0 and an OUTLET plane at x = -1 over the tube's cross-section."""
    nx, ny, nz = shape
    g = np.full(tuple(shape), SOLID, dtype=np.uint8)
    t = np.linspace(0, 1, 160)
    cx = 8 + (nx - 16) * t
    cy = ny / 2 + 0.25 * ny * np.sin(2.2 * np.pi * t)
    cz = nz / 2 + 0.18 * nz * np.cos(1.7 * np.pi * t)
    pts = np.stack([cx, cy, cz], axis=1)
    _tube(g, pts, np.full(len(t), radius))
    mid = pts[len(t) // 2] + np.array([0.0, radius + bulge * 0.5, 0.0])
    _tube(g, mid[None, :], np.array([bulge]))
    fluid0 = g[1, :, :] == FLUID
    g[0, :, :] = np.where(fluid0, INLET, SOLID)
    g[1, :, :] = np.where(fluid0, g[1, :, :], SOLID)
    fl = g[-2, :, :] == FLUID
    g[-1, :, :] = np.where(fl, OUTLET, SOLID)
    g[-2, :, :] = np.where(fl, g[-2, :, :], SOLID)
    return g


GENERATORS = {"vessel_aneurysm": vessel_aneurysm, "random_spheres": random_spheres}


def make_geometry(geometry: dict) -> np.ndarray:
    """The dense (X, Y, Z) uint8 node-type grid a configuration's
    ``geometry`` entry names: ``{"generator": name, **arguments}``."""
    args = dict(geometry)
    return GENERATORS[args.pop("generator")](**args)
