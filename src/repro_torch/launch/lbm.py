"""LBM launcher: run the paper's solver, on one device or cut into z slabs.

    # the paper's fused path on the card, double precision
    PYTHONPATH=src python -m repro_torch.launch.lbm --case spheres --scale 4 \\
        --backend fused --dtype float64

    # the plain PyTorch versions of the kernels on the CPU (small cases)
    PYTHONPATH=src python -m repro_torch.launch.lbm --case duct --device cpu

    # the slab-sharded engine: 4 slabs (on the CPU here; on the card the
    # slabs default to one per visible card, and --slabs D places D slabs
    # on the cards there are)
    PYTHONPATH=src python -m repro_torch.launch.lbm --case duct --device cpu \
        --slabs 4

    # split-phase streaming on the gather backend, with the metric registry
    # (JSONL) and the host spans (Chrome trace) written out
    PYTHONPATH=src python -m repro_torch.launch.lbm --case duct --device cpu \
        --backend gather --split-stream --metrics-out m.jsonl --trace t.json

    # the dry-run: one step of the production slab meshes (16 or 32 slabs
    # of a deepened duct, one an H100) counted on the meta device; the
    # reference's gather backend by default, --backend fused for K1's path
    PYTHONPATH=src python -m repro_torch.launch.lbm --dryrun --mesh both \
        --out results/lbm_dryrun.json

The run warms up with ``--steps`` steps, resets to t = 0 and times
``--steps`` steps.  On the card the time comes from CUDA events around the
launch loop; on the CPU from the host clock.  It prints MFLUPS, the
bandwidth of the paper's Eqn-10 minimum traffic (2·Q·n_fluid·sizeof(dtype)
bytes per step) and the kernel launches of the timed run; sharded, also
the slabs, the devices they sit on and the halo bytes per step.  A case
whose z tile-layers cannot feed the slabs (one layer each, two with a
periodic z) runs on one device, as the reference's launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import hw, obs
from repro_torch.core import collision as C
from repro_torch.core.boundary import BoundarySpec
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.core.tiling import INLET, NODE_ORDERS, OUTLET, TILE_ORDERS
from repro_torch.data import geometry as geo
from repro_torch.dist.lbm import ShardedLBM
from repro_torch.kernels.collide import collide_tiles
from repro_torch.kernels.nebb_pass import nebb_boundary_pass
from repro_torch.kernels.stream_collide import stream_collide_tiles
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.roofline.analysis import collective_time


@dataclasses.dataclass
class Case:
    """A runnable scenario: geometry + boundary conditions + engine knobs."""

    geometry: np.ndarray
    boundaries: tuple = ()
    periodic: tuple = (False, False, False)
    lattice: str = "D3Q19"
    force: tuple | None = None


_Z_FLOW = ((INLET, BoundarySpec("velocity", (0, 0, 1),
                                velocity=(0, 0, 0.02))),
           (OUTLET, BoundarySpec("pressure", (0, 0, -1), rho=1.0)))
_X_FLOW = ((INLET, BoundarySpec("velocity", (1, 0, 0),
                                velocity=(0.02, 0, 0))),
           (OUTLET, BoundarySpec("pressure", (-1, 0, 0), rho=1.0)))

CASES = ("cavity", "duct", "spheres", "vessel", "aorta", "channel2d")


def make_case(name: str, scale: int = 1) -> Case:
    """The reference launcher's cases, geometry for geometry."""
    if name == "cavity":
        return Case(
            geo.cavity3d(48 * scale),
            ((geo.LID, BoundarySpec("velocity", (0, 0, -1),
                                    velocity=(0.05, 0.0, 0.0))),))
    if name == "duct":
        g = geo.duct(24 * scale, 24 * scale, 96 * scale)
        bcs = ((INLET, BoundarySpec("velocity", (0, 0, 1),
                                    velocity=(0, 0, 0.05))),
               (OUTLET, BoundarySpec("pressure", (0, 0, -1), rho=1.0)))
        return Case(g, bcs)
    if name == "spheres":
        return Case(geo.duct_wrap(
            geo.random_spheres(box=64 * scale, porosity=0.7, diameter=16)),
            _Z_FLOW)
    if name == "vessel":
        return Case(geo.vessel_aneurysm(
            (64 * scale, 48 * scale, 48 * scale),
            radius=8.0 * scale, bulge=12.0 * scale), _X_FLOW)
    if name == "aorta":
        return Case(geo.aorta_coarctation(
            (48 * scale, 64 * scale, 96 * scale), radius=9.0 * scale),
            _Z_FLOW)
    if name == "channel2d":
        return Case(geo.channel2d(32 * scale, 32 * scale),
                    periodic=(True, False, True), lattice="D2Q9",
                    force=(1e-5, 0.0, 0.0))
    raise ValueError(f"unknown case {name!r}; expected one of {CASES}")


def dryrun(multi_pod: bool, collision: str = "lbgk", fluid: str = "incompressible",
           verbose: bool = True, node_order: str = "canonical",
           split_stream: bool = False, backend: str = "gather") -> dict:
    """One step of the slab-sharded engine on a production mesh, counted
    for one H100 a slab on the meta device (``ShardedLBM.count_step``; the
    reference lowers and compiles it for a TPU pod): 16 slabs over "data"
    (32 over "pod" x "data" with ``multi_pod``) of the duct deepened so that
    every slab holds >= 2 tile layers, float32.  The per-device figures are
    the busiest slab's.  Returns the reference's keys; ``metrics`` holds
    the engine's model metrics under the runtime's names."""
    mesh = make_production_mesh(multi_pod)
    axis = "pod,data" if multi_pod else "data"
    slabs = 2 * 16 if multi_pod else 16        # slab axis = pod x data
    case = make_case("duct", scale=1)
    # deepen z so every slab holds >= 2 tile layers
    reps = max(1, (slabs * 2 * 4) // case.geometry.shape[2] + 1)
    g = np.concatenate([case.geometry] * reps, axis=2)
    cfg = LBMConfig(
        collision=C.CollisionConfig(model=collision, fluid=fluid, tau=0.6),
        layout_scheme="paper" if backend == "gather" else "xyz", dtype="float32",
        boundaries=case.boundaries, periodic=case.periodic, node_order=node_order,
        split_stream=split_stream, backend=backend)
    t0 = time.time()
    eng = ShardedLBM(g, cfg, slabs=slabs, devices="meta")
    counts = eng.count_step(axis)
    dt = time.time() - t0
    c = max(counts, key=lambda k: (k.bytes, k.flops))
    n_own, q = eng.plan.n_fluid_own, eng.lat.q
    # paper Eqn (10): minimum bytes per node per step = 2 q n_d
    min_bytes_global = 2 * q * eng.dtype.itemsize * n_own
    terms = {"t_compute": c.flops / hw.PEAK_FLOPS[eng.dtype],
             "t_memory": c.bytes / hw.HBM_BYTES_PER_S,
             "t_collective": collective_time(mesh, c.coll_by_axis())}
    dominant = max(terms, key=terms.get)
    fracs = eng.stream_fracs
    out = {
        "mesh": mesh.name, "chips": mesh.chips, "slabs": eng.plan.n_dev,
        "geometry": list(g.shape), "fluid_nodes": n_own,
        "tile_utilisation": round(eng.plan.tile_utilisation, 4),
        "interior_frac": round(fracs["interior_frac"], 4),
        "frontier_frac": round(fracs["frontier_frac"], 4),
        "bounce_frac": round(fracs["bounce_frac"], 4),
        "node_order": node_order, "split_stream": split_stream, "backend": backend,
        "flops_per_device": c.flops, "bytes_per_device": c.bytes,
        "coll_bytes_per_device": c.collective_bytes, "coll_by_op": c.coll_by_op(),
        "min_bytes_per_device": min_bytes_global / eng.plan.n_dev,
        "bw_efficiency_model": (min_bytes_global / eng.plan.n_dev) / max(c.bytes, 1.0),
        **terms, "dominant": dominant, "peak_bytes_per_device": float(c.peak),
        "kernels": {k: list(v) for k, v in c.kernels.items()},
        "count_s": round(dt, 1), "ok": True,
    }
    # the runtime's metric names, so that modelled and measured join on a
    # key, plus the counted per-device figures
    out["metrics"] = {**eng.model_metrics(),
                      "lbm.bw.eqn10_fraction_hlo": out["bw_efficiency_model"],
                      "lbm.bytes.hlo_per_device": float(c.bytes)}
    reg = obs.get_metrics()
    if reg.enabled:
        for name, v in out["metrics"].items():
            reg.gauge(name, mesh=out["mesh"]).set(v)
    if verbose:
        print(f"[LBM x {out['mesh']}] OK slabs={out['slabs']} geom={out['geometry']} "
              f"fluid={n_own:,} backend={backend}")
        print(f"  eta_t={out['tile_utilisation']} interior={out['interior_frac']} "
              f"frontier={out['frontier_frac']} bounce={out['bounce_frac']}")
        print(f"  terms: compute={terms['t_compute'] * 1e6:.1f}us "
              f"memory={terms['t_memory'] * 1e6:.1f}us "
              f"collective={terms['t_collective'] * 1e6:.1f}us -> dominant={dominant}; "
              f"Eqn10-min/counted bytes={out['bw_efficiency_model']:.3f}")
    return out


def launch_counts() -> dict[str, int]:
    return {"stream_collide_tiles": stream_collide_tiles.launches,
            "collide_tiles": collide_tiles.launches,
            "nebb_boundary_pass": nebb_boundary_pass.launches}


def reset_launch_counts() -> None:
    stream_collide_tiles.launches = 0
    collide_tiles.launches = 0
    nebb_boundary_pass.launches = 0


def timed_run(eng, steps: int) -> float:
    """Seconds for ``eng.run(steps)``: CUDA events on the card (after a
    synchronise), the host clock on the CPU and, between synchronises of
    every card, across several cards."""
    devices = set(getattr(eng, "devices", [eng.device]))
    if len(devices) == 1 and eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.run(steps)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    cards = [d for d in devices if d.type == "cuda"]
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    eng.run(steps)
    for d in cards:
        torch.cuda.synchronize(d)
    return time.perf_counter() - t0


def run_local(args) -> dict:
    case = make_case(args.case, args.scale)
    cfg = LBMConfig(
        lattice=case.lattice,
        collision=C.CollisionConfig(model=args.collision, fluid=args.fluid,
                                    tau=args.tau),
        layout_scheme="xyz" if args.backend == "fused" else "paper",
        dtype=args.dtype, boundaries=case.boundaries, periodic=case.periodic,
        force=case.force, backend=args.backend, tile_order=args.order,
        node_order=args.node_order, use_kernel=args.backend == "gather",
        split_stream=args.split_stream)
    mesh = make_host_mesh(args.slabs, args.device)
    n_dev = len(mesh)
    # a case is slab-decomposable only if every slab can own >= 1 z
    # tile-layer (2 with a wrapped periodic-z halo) — channel2d, for one,
    # is a single tile layer thick and must run single-device
    tz = -(-case.geometry.shape[2] // cfg.a)
    sharded = n_dev > 1 and tz >= n_dev * (2 if case.periodic[2] else 1)
    if n_dev > 1 and not sharded:
        print(f"case={args.case}: {tz} z tile-layer(s) cannot feed "
              f"{n_dev} slabs; running single-device")
    if sharded:
        eng = ShardedLBM(case.geometry, cfg, devices=mesh)
        tiles = sum(t.num_tiles for t in eng.plan.local_tilings)
        eta_t = eng.plan.tile_utilisation
    else:
        eng = SparseTiledLBM(case.geometry, cfg, device=mesh[0])
        tiles, eta_t = eng.tiling.num_tiles, eng.tiling.tile_utilisation
    setup_spans = len(obs.get_tracer().spans)
    eng.run(args.steps)            # warm-up
    eng.reset()                    # back to t=0: the timed run IS the physics
    del obs.get_tracer().spans[setup_spans:]   # drop the warm-up's spans
    reset_launch_counts()
    dt = timed_run(eng, args.steps)
    launches = launch_counts()
    sec = dt / args.steps
    min_bytes = 2 * eng.lat.q * eng.n_fluid_nodes * eng.dtype.itemsize
    reg = obs.get_metrics()
    if reg.enabled:
        for name, v in eng.model_metrics().items():
            reg.gauge(name, case=args.case).set(v)
        reg.gauge("lbm.step.mflups", case=args.case).set(eng.mflups(sec))
        reg.gauge("lbm.step.seconds", case=args.case).set(sec)
        reg.gauge("lbm.bw.achieved_gbs", case=args.case).set(min_bytes / sec / 1e9)
        reg.gauge("lbm.mass.total", case=args.case).set(eng.total_mass())
    out = {
        "case": args.case, "scale": args.scale, "backend": args.backend,
        "dtype": args.dtype, "device": str(eng.device),
        "device_name": (torch.cuda.get_device_name(eng.device)
                        if eng.device.type == "cuda" else "cpu"),
        "fluid_nodes": eng.n_fluid_nodes, "tiles": tiles, "eta_t": eta_t,
        "slabs": n_dev if sharded else 1,
        "devices": len(set(mesh)) if sharded else 1,
        "halo_bytes": eng.halo_bytes_per_step() if sharded else 0,
        "halo_bytes_moved": eng.halo_bytes_moved_per_step() if sharded else 0,
        "steps": args.steps,
        "seconds": dt, "mflups": eng.mflups(sec),
        "eqn10_gbs": min_bytes / sec / 1e9, "launches": launches,
        "mass": eng.total_mass(),
    }
    stream = "split" if args.split_stream else "mono"
    print(f"case={args.case} scale={args.scale} backend={args.backend} "
          f"stream={stream} dtype={args.dtype} device={out['device_name']} "
          f"devices={out['devices']} slabs={out['slabs']} "
          f"fluid={out['fluid_nodes']:,} eta_t={out['eta_t']:.3f} "
          f"steps={args.steps} {dt:.4f}s -> {out['mflups']:.1f} MFLUPS, "
          f"Eqn-10 {out['eqn10_gbs']:.1f} GB/s, launches={launches}")
    if sharded:
        print(f"halo: {out['halo_bytes']:,} B per step (the reference's "
              f"padded count), {out['halo_bytes_moved']:,} B moved")
    print(f"mass = {out['mass']:.6f} after {args.steps} steps")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true",
                    help="count one step of the production slab meshes on the meta "
                         "device (no card) instead of running")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both",
                    help="the dry-run's mesh: 16 slabs, 32, or both")
    ap.add_argument("--out", default=None, help="the dry-run's JSON output path")
    ap.add_argument("--case", default="duct", choices=list(CASES))
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--order", default="zmajor", choices=list(TILE_ORDERS),
                    help="tile traversal policy (data placement)")
    ap.add_argument("--node-order", default="canonical",
                    choices=list(NODE_ORDERS), dest="node_order",
                    help="within-tile node enumeration (data placement)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tau", type=float, default=0.6)
    ap.add_argument("--collision", default="lbgk", choices=["lbgk", "lbmrt"])
    ap.add_argument("--fluid", default="incompressible",
                    choices=["incompressible", "quasi_compressible"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--backend", default=None, choices=["gather", "fused"],
                    help="fused: kernel K1; gather: gather streaming + K2 "
                         "(default: fused, and gather for --dryrun, as the "
                         "reference's dry-run)")
    ap.add_argument("--split-stream", action="store_true", dest="split_stream",
                    help="split-phase streaming: static interior permutation "
                         "+ compact frontier tables (gather backend only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--slabs", type=int, default=None,
                    help="z slabs of the sharded engine, placed on the "
                         "visible cards in contiguous blocks (default: one "
                         "per visible card; 1 on the CPU)")
    ap.add_argument("--metrics-out", default=None, dest="metrics_out",
                    help="write the obs metric registry as JSONL here")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON (perfetto-loadable) of "
                         "the host spans here; also names the step phases "
                         "in torch.profiler traces")
    args = ap.parse_args(argv)
    if args.metrics_out or args.trace:
        # before the engine is built, so construction spans are captured
        obs.enable(metrics=True, trace=bool(args.trace))
    if args.dryrun:
        meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
        results = [dryrun(mp, args.collision, args.fluid, node_order=args.node_order,
                          split_stream=args.split_stream, backend=args.backend or "gather")
                   for mp in meshes]
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        write_obs_outputs(args)
        return 0
    args.backend = args.backend or "fused"
    run_local(args)
    write_obs_outputs(args)
    return 0


def write_obs_outputs(args) -> None:
    """Export the global obs collectors per the CLI flags (shared with
    ``repro_torch.launch.sim_serve``)."""
    if getattr(args, "metrics_out", None):
        print(f"metrics -> {obs.get_metrics().write_jsonl(args.metrics_out)}")
    if getattr(args, "trace", None):
        print(f"trace -> {obs.get_tracer().save(args.trace)}")


if __name__ == "__main__":
    sys.exit(main())
