"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size; the benchmark's runs never run this.

    python3 lbmbench/calibrate.py --workload vessel-inflow-f64 \\
        --seeds 1001-1012 --control-seeds 1001-1003 --window-steps 500

For a solver cell, in one process: the program's gaps on every seed (the
start's ``start_steps`` from the seeded state and the ``end_steps`` after
``--window-steps`` steps of the program, as a run compares them), and the
control's on the control seeds: the reference itself computed in the next
precision below the cell's (float32 for float64, bfloat16 for float32) in
the program's place, from the same inputs.  For a service cell: the
control's session gap against the float64 reference, at the budgets and
probe points of ``--sessions`` sessions of the cell's closed loop on each
control seed (the program's own readings are its runs' ``session_gap``).
Prints one line per reading and the largest and smallest of each.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lbmbench import harness as h  # noqa: E402
from lbmbench.geometry import SOLID, make_geometry  # noqa: E402
from lbmbench.layout import PortLayout  # noqa: E402
from lbmbench.reference import Reference, fluid_nodes, seeded_state  # noqa: E402
from lbmbench.service import check_sessions  # noqa: E402
from lbmbench.solver import DTYPES, max_gap  # noqa: E402

BELOW = {"float64": torch.float32, "float32": torch.bfloat16}


def seeds(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def solver(config: dict, traffic: dict, args, dev: torch.device) -> None:
    from repro_torch.core.engine import SparseTiledLBM

    dtype, below = DTYPES[traffic["dtype"]], BELOW[traffic["dtype"]]
    geometry = make_geometry(config["geometry"])
    ph, init = config["physics"], traffic["init"]
    eng = SparseTiledLBM(geometry, h.lbm_config(config, traffic["dtype"]), device=dev)
    g = torch.as_tensor(geometry, device=dev)
    coords, index = fluid_nodes(g)
    n = len(coords)
    layout = PortLayout(g, index, eng.tiling.node_coords(), eng.tiling.node_types)
    del coords, index, g
    ref = Reference(geometry, ph, dev, torch.float64)
    ctl = Reference(geometry, ph, dev, below)
    start, end = traffic["start_steps"], traffic["end_steps"]
    readings = {"start_gap": [], "window_gap": [], "control start_gap": [],
                "control window_gap": []}
    for seed in args.seeds:
        f0 = seeded_state(n, dev, seed, init["amp_rho"], init["amp_u"], ph["rho0"], ph["u0"])
        eng.f = eng.backend.initial_state(layout.pack(f0.to(dtype)))
        eng.run(start)
        out, _ = layout.unpack(eng.backend.canonical(eng.f))
        ref_start = ref.run(f0.to(dtype), start)
        readings["start_gap"].append(max_gap(out, ref_start))
        eng.run(args.window_steps)
        snap, _ = layout.unpack(eng.backend.canonical(eng.f))
        eng.run(end)
        out, _ = layout.unpack(eng.backend.canonical(eng.f))
        ref_end = ref.run(snap, end)
        readings["window_gap"].append(max_gap(out, ref_end))
        if seed in args.control_seeds:
            readings["control start_gap"].append(max_gap(ctl.run(f0.to(dtype), start), ref_start))
            readings["control window_gap"].append(max_gap(ctl.run(snap, end), ref_end))
        print(f"seed {seed}: " + ", ".join(f"{k} {v[-1]!r}" for k, v in readings.items()
                                           if len(v) and (seed in args.control_seeds
                                                          or not k.startswith("control"))),
              flush=True)
    summary(readings)


def service(config: dict, traffic: dict, args, dev: torch.device) -> None:
    from lbmbench.service import ClosedLoop

    geometry = make_geometry(config["geometry"])
    ph = config["physics"]
    points = np.argwhere(geometry != SOLID)
    # the budgets of the closed loop's first sessions, each client's in turn
    budgets = ClosedLoop.budget_list(traffic)
    ref = Reference(geometry, ph, dev, torch.float64)
    ctl = Reference(geometry, ph, dev, BELOW[traffic["dtype"]])
    f0 = ref.equilibrium(torch.full((ref.n,), float(ph["rho0"]), dtype=torch.float64, device=dev),
                         torch.as_tensor(ph["u0"], dtype=torch.float64, device=dev)[:, None]
                         .expand(3, ref.n))
    readings = {"control session_gap": []}
    for seed in args.control_seeds:
        rng = np.random.default_rng(seed)
        order = budgets.T.reshape(-1)[:args.sessions]
        # the control's results in the program's place, judged by the reference
        finished, f, done = [], f0.to(ctl.dtype), 0
        for budget in sorted(set(int(b) for b in order)):
            f = ctl.run(f, budget - done)
            done = budget
            rho, u = (m.to(torch.float64) for m in ctl.macroscopics(f))
            speed = (u * u).sum(dim=0).sqrt()
            for b in order[order == budget]:
                pts = points[rng.integers(0, len(points), size=traffic["probes_per_session"])]
                idx = ref.index[tuple(torch.as_tensor(pts.T, device=dev))].tolist()
                finished.append((budget, {
                    "steps": budget, "mass": float(f.to(torch.float64).sum()),
                    "mean_speed": float(speed.mean()), "max_speed": float(speed.max()),
                    "probes": [{"point": p.tolist(), "rho": float(rho[i]),
                                "u": [float(v) for v in u[:, i]]} for p, i in zip(pts, idx)]}))
        readings["control session_gap"].append(check_sessions(ref, f0, finished))
        print(f"seed {seed}: control session_gap {readings['control session_gap'][-1]!r} "
              f"over {len(finished)} sessions", flush=True)
    summary(readings)


def summary(readings: dict) -> None:
    for name, values in readings.items():
        if values:
            print(f"[readings] {name}: largest {max(values)!r}, smallest {min(values)!r} "
                  f"over {len(values)} seeds")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=seeds("1001-1012"))
    ap.add_argument("--control-seeds", type=seeds, default=seeds("1001-1003"))
    ap.add_argument("--window-steps", type=int, default=500)
    ap.add_argument("--sessions", type=int, default=24)
    args = ap.parse_args()
    bench = h.load_benchmark()
    cell = h.entry(bench["workloads"], args.workload)
    config, traffic = h.load_config(bench, cell["config"]), h.load_traffic(cell["traffic"])
    dev = torch.device("cuda", 0)
    print(f"[card] {torch.cuda.get_device_name(dev)}", flush=True)
    t = time.perf_counter()
    {"solver": solver, "service": service}[traffic["kind"]](config, traffic, args, dev)
    print(f"[done] {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
