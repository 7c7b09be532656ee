"""End-to-end sparse-geometry flow: blood-vessel-like geometry, inlet/outlet
driven, with convergence monitoring — the paper's headline use case (the
PyTorch port).

    PYTHONPATH=src python examples/torch/sparse_flow.py [--steps 400]
    PYTHONPATH=src python examples/torch/sparse_flow.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import collision as C
from repro_torch.core.boundary import BoundarySpec
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.core.tiling import INLET, OUTLET
from repro_torch.data.geometry import vessel_aneurysm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--check-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    geometry = vessel_aneurysm((96, 72, 72), radius=8.0, bulge=16.0)
    cfg = LBMConfig(
        collision=C.CollisionConfig(model="lbgk", fluid="incompressible",
                                    tau=0.55),
        layout_scheme="paper", dtype="float32",
        boundaries=((INLET, BoundarySpec("velocity", (1, 0, 0),
                                         velocity=(0.04, 0, 0))),
                    (OUTLET, BoundarySpec("pressure", (-1, 0, 0), rho=1.0))),
    )
    eng = SparseTiledLBM(geometry, cfg, device=args.device)
    t = eng.tiling
    print(f"geometry {geometry.shape}: porosity={t.porosity:.3f} "
          f"eta_t={t.tile_utilisation:.3f} tiles={t.num_tiles} "
          f"(paper Table 8 analogue)")

    prev_u = None
    t0 = time.time()
    for it in range(0, args.steps, args.check_every):
        eng.run(args.check_every)
        rho, u = eng.fields_dense()
        umax = float(np.nanmax(np.linalg.norm(u, axis=0)))
        delta = (float(np.nanmax(np.abs(u - prev_u)))
                 if prev_u is not None else float("nan"))
        prev_u = u
        print(f"step {it + args.check_every:5d}  max|u|={umax:.5f}  "
              f"delta={delta:.2e}")
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    print(f"{eng.n_fluid_nodes * args.steps / dt / 1e6:.2f} MFLUPS "
          f"({dt:.1f}s wall)")


if __name__ == "__main__":
    main()
