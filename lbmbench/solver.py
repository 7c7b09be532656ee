"""The solver cells: one ``SparseTiledLBM`` on the fused path, stepped back
to back for the window.

Set-up builds the engine from the configuration, hands it the seeded
initial state and drives its first ``start_steps`` steps through
``run``, keeping that state on the host; ``rate_steps`` more steps time a
step, and the window is the number of steps that fills ``--seconds``.
The window ends with ``end_steps`` steps from a copy of the program's own
state.  After it the program is freed and the reference follows the start
from the seeded state and the window's last steps from that copy; every
node of both is compared, and every solid slot must hold zero.
"""
from __future__ import annotations

import time

import torch

from . import harness as h
from .geometry import make_geometry
from .layout import PortLayout
from .reference import Reference, fluid_nodes, seeded_state
from .trace import profile_segment
from .yardstick import eqn10_bytes

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def max_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between the program's values and the reference's,
    in float64; NaN anywhere reads NaN."""
    return float((prog.to(torch.float64) - ref.to(torch.float64)).abs().max())


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float, log=print):
    from repro_torch.core.engine import SparseTiledLBM

    dtype = DTYPES[traffic["dtype"]]
    geometry = make_geometry(config["geometry"])
    h.reset_peak(dev)
    eng = SparseTiledLBM(geometry, h.lbm_config(config, traffic["dtype"]), device=dev)
    peak = h.peak_bytes(dev)                # the program's own set-up
    g = torch.as_tensor(geometry, device=dev)
    coords, index = fluid_nodes(g)
    n_fluid = len(coords)
    layout = PortLayout(g, index, eng.tiling.node_coords(), eng.tiling.node_types)
    del coords, index, g
    init = traffic["init"]
    f0 = seeded_state(n_fluid, dev, seed, init["amp_rho"], init["amp_u"],
                      config["physics"]["rho0"], config["physics"]["u0"])
    eng.f = eng.backend.initial_state(layout.pack(f0.to(dtype)))
    del f0
    eng.run(traffic["start_steps"])
    start_out, start_solid = layout.unpack(eng.backend.canonical(eng.f))
    start_out = start_out.cpu()               # held off the card until the check
    step_s = h.device_seconds(lambda: eng.run(traffic["rate_steps"]), dev) / traffic["rate_steps"]
    end = traffic["end_steps"]
    steps = max(end + 1, round(seconds / step_s))
    layout.to("cpu")
    h.free(dev)
    summary = None
    if trace:
        summary = profile_segment(lambda: eng.run(traffic["trace_steps"]),
                                  lambda: eng.run(5), traffic["trace_steps"])
    h.sync(dev)
    h.reset_peak(dev)
    with h.HostMeter() as host:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        eng.run(steps - end)
        peak = max(peak, h.peak_bytes(dev))
        snap = eng.f.clone()                  # the program's state `end` steps before the close
        eng.run(end)
        h.sync(dev)
        window_s = time.perf_counter() - t0
    log(host.line)
    log(f"[window] {steps} steps in {window_s:.4f} s ({step_s * 1e3:.4f} ms a step "
        f"estimated in set-up); setup {setup_s:.4f} s; peak {peak} B")

    # ----- the check: the program freed, the reference on its own
    snap, post = eng.backend.canonical(snap), eng.backend.canonical(eng.f)
    del eng
    h.free(dev)
    layout.to(dev)
    end_in, solid_in = layout.unpack(snap)
    del snap
    end_out, solid_out = layout.unpack(post)
    del post
    h.free(dev)
    t_ref = time.perf_counter()
    ref = Reference(geometry, config["physics"], dev, torch.float64)
    f0 = seeded_state(n_fluid, dev, seed, init["amp_rho"], init["amp_u"],
                      config["physics"]["rho0"], config["physics"]["u0"]).to(dtype)
    checks = h.Checks(traffic["limits"])
    checks.add("layout_faults", layout.faults)
    checks.add("start_gap", max_gap(start_out.to(dev), ref.run(f0, traffic["start_steps"])))
    del f0, start_out
    checks.add("window_gap", max_gap(end_out, ref.run(end_in, end)))
    checks.add("solid_max", max(start_solid, solid_in, solid_out))
    log(f"[check] reference {time.perf_counter() - t_ref:.4f} s over {n_fluid} nodes")

    itemsize = torch.empty((), dtype=dtype).element_size()
    ctx = {"trace": summary, "n_fluid": n_fluid, "itemsize": itemsize, "replicas": 1,
           "window": {"seconds": window_s, "steps": steps, "updates": steps * n_fluid},
           "measured": {"mflups": steps * n_fluid / window_s / 1e6, "setup_s": setup_s}}
    log(f"[eqn10] {eqn10_bytes(n_fluid, itemsize):.6e} B a step")
    return {"attempted": steps, "failed": 0}, ctx, checks, peak

