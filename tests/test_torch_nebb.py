"""The fused backend's NEBB pass over its boundary nodes (CPU): the plain
version, restricted to the nodes, against the whole-tile pass it replaced,
on a duct along each of the three axes, open either way, so that the
velocity inlet and the pressure outlet each take all six axis normals."""
import numpy as np
import pytest
import torch

from repro_torch.core import collision as C
from repro_torch.core.boundary import BoundarySpec, apply_open_boundary
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.core.streaming import build_stream_tables
from repro_torch.core.tiling import INLET, OUTLET, SOLID
from repro_torch.data.geometry import duct_wrap, random_spheres
from repro_torch.kernels.nebb_pass import nebb_boundary_pass
from repro_torch.kernels.stream_collide import (packed_gather_indices,
                                                stream_collide_tiles_ref)

FORCE = (1e-4, -2e-4, 3e-4)
# (axis, sign, collision model, fluid, force, replicas, dtype)
CASES = [(2, 1, C.LBGK, C.INCOMPRESSIBLE, None, 1, torch.float64),
         (2, -1, C.LBMRT, C.QUASI_COMPRESSIBLE, FORCE, 3, torch.float64),
         (0, 1, C.LBMRT, C.INCOMPRESSIBLE, None, 3, torch.float64),
         (0, -1, C.LBGK, C.QUASI_COMPRESSIBLE, FORCE, 1, torch.float64),
         (1, 1, C.LBGK, C.INCOMPRESSIBLE, FORCE, 3, torch.float32),
         (1, -1, C.LBMRT, C.QUASI_COMPRESSIBLE, None, 1, torch.float64)]


def _duct(axis: int, sign: int):
    """duct_wrap's z duct turned to run along ``axis``, its inlet on the low
    face (sign 1) or the high one (-1), with the flow's specs."""
    g = np.moveaxis(duct_wrap(random_spheres(box=16, porosity=0.6, diameter=8, seed=1)),
                    2, axis)
    if sign < 0:
        g = np.flip(g, axis).copy()
    normal = tuple(sign if a == axis else 0 for a in range(3))
    return g, ((INLET, BoundarySpec("velocity", normal,
                                    velocity=tuple(0.03 * c for c in normal))),
               (OUTLET, BoundarySpec("pressure", tuple(-c for c in normal), rho=1.01)))


def _whole_tile_pass(f_pre, out, eng, replicas):
    """The pass this port ran before its node tables: every slot of every
    replica's boundary tiles re-streamed through the packed gather, rebuilt
    by ``apply_open_boundary`` per spec, collided by ``collision.collide``
    and solid slots zeroed."""
    tiling, lat, cfg = eng.tiling, eng.lat, eng.cfg
    types = tiling.node_types
    t, n = types.shape
    q = lat.q
    bt = np.nonzero(np.isin(types, [tv for tv, _ in cfg.boundaries]).any(axis=1))[0]
    rows = build_stream_tables(tiling, lat, "xyz", cfg.periodic, tiles=bt)
    packed = packed_gather_indices(rows.gather_idx, q, t, n).astype(np.int64)
    gather = np.concatenate([packed + r * t * q * n for r in range(replicas)], axis=1)
    f_in = torch.take(f_pre, torch.as_tensor(gather)).reshape(q, -1, n)
    for tv, spec in cfg.boundaries:
        mask = torch.as_tensor(np.concatenate([types[bt] == tv] * replicas))
        f_in = apply_open_boundary(f_in, mask, spec, lat)
    f_out, _, _ = C.collide(f_in, lat, cfg.collision, cfg.force)
    solid = torch.as_tensor(np.concatenate([types[bt] == SOLID] * replicas))
    tiles = np.concatenate([bt + r * t for r in range(replicas)])
    out[torch.as_tensor(tiles)] = f_out.masked_fill(solid[None], 0.0).movedim(0, 1)
    return out


@pytest.mark.parametrize("axis,sign,model,fluid,force,replicas,dtype", CASES)
def test_node_pass_matches_whole_tile_pass(axis, sign, model, fluid, force, replicas,
                                           dtype):
    """After K1 (its plain version) over every replica's tiles, the pass over
    the boundary nodes leaves the state the whole-tile pass leaves, within
    1e-12 in float64 (1e-6 in float32); it launched no kernel."""
    g, bcs = _duct(axis, sign)
    cfg = LBMConfig(backend="fused", boundaries=bcs, force=force,
                    dtype="float64" if dtype == torch.float64 else "float32",
                    collision=C.CollisionConfig(model, fluid, 0.7))
    eng = SparseTiledLBM(g, cfg, device="cpu")
    b = eng.backend
    types, nbrs, bc = b._ensemble_tables(replicas)
    rng = np.random.default_rng(10 * axis + sign + 1)
    f = b.ensemble_state(eng.backend.canonical(eng.f), replicas)
    f[:-1] *= torch.as_tensor(1.0 + rng.uniform(-1e-3, 1e-3, f[:-1].shape), dtype=dtype)
    f[:-1] = f[:-1].masked_fill((types[:-1] == SOLID)[:, None, :], 0.0)
    k1 = stream_collide_tiles_ref(f, types, nbrs, eng.lat, cfg.collision, force=force)
    before = nebb_boundary_pass.launches
    got = nebb_boundary_pass(f, k1.clone(), eng.lat, cfg.collision, force,
                             b._specs, bc)
    want = _whole_tile_pass(f, k1.clone(), eng, replicas)
    assert nebb_boundary_pass.launches == before
    assert float((got - want).abs().max()) <= (1e-12 if dtype == torch.float64 else 1e-6)
    t, n = eng.tiling.num_tiles, eng.tiling.nodes_per_tile
    nodes = ((bc.tiles.long() * n + bc.slots.long())[None]
             + torch.arange(replicas)[:, None] * t * n).reshape(-1)
    changed = torch.nonzero((got != k1).any(dim=1)[:-1].reshape(-1))[:, 0]
    assert len(changed) and set(changed.tolist()) <= set(nodes.tolist())
