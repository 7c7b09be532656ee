"""Quickstart: the paper's sparse-tiled LBM in ~30 lines (the PyTorch port).

    PYTHONPATH=src python examples/torch/quickstart.py               # on the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import collision as C
from repro_torch.core.boundary import BoundarySpec
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.data.geometry import LID, cavity3d

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--size", type=int, default=32)
ap.add_argument("--steps", type=int, default=500)
args = ap.parse_args()
n = args.size

# lid-driven cavity, 32^3 nodes, lid moving in +x at the top z face
geometry = cavity3d(n)

cfg = LBMConfig(
    collision=C.CollisionConfig(model="lbgk", fluid="incompressible", tau=0.6),
    layout_scheme="paper",          # the paper's L_XYZ/L_YXZ/L_zigzagNE blocks
    dtype="float32",
    boundaries=((LID, BoundarySpec("velocity", (0, 0, -1),
                                   velocity=(0.05, 0.0, 0.0))),),
)
engine = SparseTiledLBM(geometry, cfg, device=args.device)
print(f"tiles={engine.tiling.num_tiles}  "
      f"tile utilisation eta_t={engine.tiling.tile_utilisation:.3f}  "
      f"fluid nodes={engine.n_fluid_nodes:,}")

engine.run(args.steps)
rho, u = engine.fields_dense()
speed = np.linalg.norm(u, axis=0)
print(f"mass={engine.total_mass():.3f}  max |u|={np.nanmax(speed):.4f} lu")
print("mid-plane x-velocity profile (z column through the centre):")
for z in range(2, n, 4):
    print(f"  z={z:2d}  u_x={u[0, n // 2, n // 2, z]: .5f}")
