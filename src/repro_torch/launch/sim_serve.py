"""Simulation-serving launcher: stand
:class:`repro_torch.sim.service.SimService` up over the launcher's geometry
cases and report ensemble throughput.  Runs on the card unless
``--device cpu``.

    # the paper's fused path on the card: 4 slots, 6 staggered sessions
    PYTHONPATH=src python -m repro_torch.launch.sim_serve --cases spheres \
        --scale 4 --backend fused --dtype float64 --sessions 6 --slots 4

    # small cases on the CPU (plain PyTorch versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.sim_serve --device cpu \
        --cases duct --sessions 2 --slots 2 --steps 5

    # throughput vs ensemble width (the amortisation curve)
    PYTHONPATH=src python -m repro_torch.launch.sim_serve \
        --cases spheres --sessions 4 --sweep-slots 1,2,4 --steps 50

    # checkpointed serving: save every 20 steps, later resume
    PYTHONPATH=src python -m repro_torch.launch.sim_serve --cases duct \
        --checkpoint-root ckpt --checkpoint-every 20
    PYTHONPATH=src python -m repro_torch.launch.sim_serve \
        --checkpoint-root ckpt --restore
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch import obs
from repro_torch.core import collision as C
from repro_torch.core.engine import LBMConfig
from repro_torch.launch.lbm import CASES, make_case, write_obs_outputs
from repro_torch.sim.registry import EngineRegistry
from repro_torch.sim.service import SimService


def case_config(case, args) -> LBMConfig:
    return LBMConfig(
        lattice=case.lattice,
        collision=C.CollisionConfig(model=args.collision, tau=args.tau),
        layout_scheme="xyz" if args.backend == "fused" else "paper",
        dtype=args.dtype, boundaries=case.boundaries, periodic=case.periodic,
        force=case.force, backend=args.backend,
        split_stream=args.split_stream)


def submit_cases(svc: SimService, args) -> list[int]:
    sids = []
    for name in args.cases.split(","):
        case = make_case(name, args.scale)
        cfg = case_config(case, args)
        for i in range(args.sessions):
            # staggered budgets exercise the slot-refill path
            sids.append(svc.submit(case.geometry, cfg,
                                   steps=args.steps + i * args.stagger))
    return sids


def warm_and_snapshot(svc: SimService) -> dict:
    """Run one admission+step so every group is built and its kernels
    loaded OUTSIDE the throughput window, then snapshot EVERY session's
    steps_done (active, queued, even warm-finished) so the MFLUPS
    numerator counts exactly the steps run inside the timed window."""
    svc.step(1)
    start = {s.sid: s.steps_done for s in svc.finished}
    start.update({s.sid: s.steps_done
                  for g in svc.groups.values() for s in g.active if s})
    start.update({s.sid: s.steps_done for s in svc.queue})
    return start


def timed_serve(svc: SimService, checkpoint_every: int):
    """``svc.run()`` on the host clock, the card synchronised at both ends:
    (finished sessions, seconds)."""
    dev = svc.registry.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    finished = svc.run(checkpoint_every=checkpoint_every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return finished, time.perf_counter() - t0


def serve_once(args, slots: int, registry) -> dict:
    svc = SimService(slots=slots, registry=registry,
                     checkpoint_root=args.checkpoint_root)
    submit_cases(svc, args)
    start_steps = warm_and_snapshot(svc)
    finished, wall = timed_serve(svc, args.checkpoint_every)
    return report(svc, finished, wall, slots, start_steps=start_steps)


def report(svc: SimService, finished, wall: float, slots: int,
           start_steps: dict | None = None) -> dict:
    """Aggregate throughput over the work done in THIS run: on a restored
    service, ``start_steps`` (sid -> steps_done at restore) excludes the
    pre-kill steps from the MFLUPS numerator."""
    start_steps = start_steps or {}
    updates = 0
    for sess in finished:
        eng = svc.groups[sess.engine_key].entry.engine
        updates += ((sess.steps_done - start_steps.get(sess.sid, 0))
                    * eng.n_fluid_nodes)
    dev = svc.registry.device
    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "slots": slots,
        "sessions_finished": len(finished),
        "wall_s": round(wall, 3),
        "aggregate_mflups": round(updates / wall / 1e6, 4) if wall else 0.0,
        "registry": svc.registry.stats(),
        "results": [s.result for s in sorted(finished, key=lambda s: s.sid)],
    }
    print(f"slots={slots} finished={len(finished)} wall={wall:.2f}s "
          f"aggregate={out['aggregate_mflups']} MFLUPS "
          f"compiled_engines={svc.registry.compiled_count}")
    for r in out["results"]:
        print(f"  sid={r['sid']} steps={r['steps']} mass={r['mass']:.6f} "
              f"drift={r['mass_drift']:.2e} mean|u|={r['mean_speed']:.2e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="duct",
                    help=f"comma-separated subset of {CASES}")
    ap.add_argument("--sessions", type=int, default=3,
                    help="sessions submitted per case")
    ap.add_argument("--slots", type=int, default=2,
                    help="fixed ensemble slots per (geometry, config) group")
    ap.add_argument("--sweep-slots", default=None, dest="sweep_slots",
                    help="comma-separated slot widths: serve the same load "
                         "once per width and report aggregate MFLUPS vs B")
    ap.add_argument("--steps", type=int, default=50,
                    help="base per-session step budget")
    ap.add_argument("--stagger", type=int, default=5,
                    help="budget increment between a case's sessions "
                         "(staggered finishes exercise slot refill)")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--tau", type=float, default=0.6)
    ap.add_argument("--collision", default="lbgk", choices=["lbgk", "lbmrt"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--backend", default="gather",
                    choices=["gather", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--split-stream", action="store_true",
                    dest="split_stream")
    ap.add_argument("--checkpoint-root", default=None, dest="checkpoint_root")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    dest="checkpoint_every")
    ap.add_argument("--restore", action="store_true",
                    help="resume every session from the latest committed "
                         "checkpoint under --checkpoint-root")
    ap.add_argument("--out", default=None)
    ap.add_argument("--metrics-out", default=None, dest="metrics_out",
                    help="write the obs metric registry as JSONL here "
                         "(per-tenant counters, aggregate MFLUPS, "
                         "modelled bandwidth fractions per group)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON (perfetto-loadable) "
                         "of the nested serving spans here")
    args = ap.parse_args(argv)

    if args.metrics_out or args.trace:
        # enable BEFORE the service is built so admission/step spans and
        # engine-construction metrics are captured
        obs.enable(metrics=True, trace=bool(args.trace))

    registry = EngineRegistry(args.device)  # shared across sweep widths
    if args.restore:
        if not args.checkpoint_root:
            raise SystemExit("--restore needs --checkpoint-root")
        svc = SimService.restore(args.checkpoint_root, slots=args.slots,
                                 registry=registry)
        start_steps = warm_and_snapshot(svc)
        finished, wall = timed_serve(svc, args.checkpoint_every)
        results = [report(svc, finished, wall, args.slots,
                          start_steps=start_steps)]
    elif args.sweep_slots:
        if args.checkpoint_root:
            # the sweep would interleave every width's saves in one root
            # and the keep-newest gc would leave --restore resuming an
            # arbitrary width's sessions
            raise SystemExit(
                "--sweep-slots cannot be combined with --checkpoint-root; "
                "checkpoint a single-width serve instead")
        results = [serve_once(args, int(b), registry=registry)
                   for b in args.sweep_slots.split(",")]
        print("B -> aggregate MFLUPS: "
              + ", ".join(f"{r['slots']}:{r['aggregate_mflups']}"
                          for r in results))
    else:
        results = [serve_once(args, args.slots, registry)]

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    write_obs_outputs(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
