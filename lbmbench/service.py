"""The service cells: ``SimService`` under a closed loop of clients.

Each client submits a session (a step budget and probe points on the
configuration's geometry) and, when the service has finished it, its next
one.  The budgets are a fixed list drawn from the traffic's own seed, the
same for every run, so that every run does the same work; the probe points
are drawn from ``--seed``.  Set-up builds the service and its engine with
one short session that is seated, stepped and finished, then hands every
client's first session in.  The window is a fixed number of service steps,
``--seconds`` times the traffic's ``service_steps_per_s``.  Every session
starts from the configuration's equilibrium, so all of them follow one
trajectory: after the window the reference runs it once, to the longest
budget that finished, and every finished session's mass, mean and largest
speed and probe values are compared with it at its own budget.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import harness as h
from .geometry import SOLID, make_geometry
from .reference import Reference
from .solver import DTYPES
from .trace import profile_segment


class ClosedLoop:
    """Clients of one service, each with its list of session budgets."""

    def __init__(self, svc, geometry: np.ndarray, cfg, traffic: dict, seed: int):
        self.svc, self.geometry, self.cfg = svc, geometry, cfg
        self.budgets = self.budget_list(traffic)
        self.next = [0] * traffic["clients"]
        self.points = np.argwhere(geometry != SOLID)
        self.rng = np.random.default_rng(seed)
        self.probes = traffic["probes_per_session"]
        self.owner: dict[int, int] = {}
        self.sessions: dict[int, object] = {}
        self.submit_s, self.submitted = 0.0, 0

    @staticmethod
    def budget_list(traffic: dict) -> np.ndarray:
        """(clients, sessions_per_client) step budgets, uniform between the
        traffic's bounds, from its own seed: the same for every run."""
        return np.random.default_rng(traffic["budget_seed"]).integers(
            traffic["budget_min"], traffic["budget_max"] + 1,
            size=(traffic["clients"], traffic["sessions_per_client"]))

    def submit(self, budget: int, client: int | None = None) -> int:
        probes = self.points[self.rng.integers(0, len(self.points), size=self.probes)]
        t = time.perf_counter()
        sid = self.svc.submit(self.geometry, self.cfg, steps=int(budget), probes=probes)
        self.submit_s += time.perf_counter() - t
        self.submitted += 1
        self.sessions[sid] = self.svc.queue[-1]
        if client is not None:
            self.owner[sid] = client
        return sid

    def submit_next(self, client: int) -> None:
        i = self.next[client]
        self.next[client] += 1
        self.submit(self.budgets[client, i], client)

    def steps(self, count: int) -> None:
        """``count`` service steps; each client whose session finished
        submits its next one."""
        for _ in range(count):
            before = len(self.svc.finished)
            self.svc.step(1)
            for sess in self.svc.finished[before:]:
                if sess.sid in self.owner:
                    self.submit_next(self.owner[sess.sid])

    def steps_done(self) -> dict[int, int]:
        return {sid: s.steps_done for sid, s in self.sessions.items()}


def session_gap(result: dict, ref: dict, probe_rho: list, probe_u: list) -> float:
    """One session's widest gap to the reference at its budget: mass
    relative to the reference's; speeds and probe velocities relative to
    the reference's largest speed; probe densities as they are."""
    scale = ref["max_speed"] or 1.0
    gaps = [abs(result["mass"] - ref["mass"]) / abs(ref["mass"]),
            abs(result["mean_speed"] - ref["mean_speed"]) / scale,
            abs(result["max_speed"] - ref["max_speed"]) / scale]
    for probe, r_rho, r_u in zip(result.get("probes", ()), probe_rho, probe_u):
        gaps.append(abs(probe["rho"] - r_rho))
        gaps += [abs(a - b) / scale for a, b in zip(probe["u"], r_u)]
    return max(gaps)


def check_sessions(ref: Reference, f: torch.Tensor, finished: list) -> float:
    """Run the reference from ``f`` through every budget in ``finished``
    ((budget, result) pairs) and return the widest session gap."""
    gap, done = 0.0, 0
    for budget in sorted({b for b, _ in finished}):
        f = ref.run(f, budget - done)
        done = budget
        rho, u = ref.macroscopics(f.to(torch.float64))
        speed = (u * u).sum(dim=0).sqrt()
        base = {"mass": float(f.to(torch.float64).sum()),
                "mean_speed": float(speed.mean()), "max_speed": float(speed.max())}
        for b, result in finished:
            if b != budget:
                continue
            pts = torch.as_tensor([p["point"] for p in result.get("probes", ())],
                                  dtype=torch.int64, device=f.device).reshape(-1, 3)
            idx = ref.index[pts[:, 0], pts[:, 1], pts[:, 2]]
            gap = max(gap, session_gap(result, base, rho[idx].tolist(), u[:, idx].T.tolist()))
    return gap


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float, log=print):
    from repro_torch.sim.service import SimService

    geometry = make_geometry(config["geometry"])
    cfg = h.lbm_config(config, traffic["dtype"])
    h.reset_peak(dev)
    svc = SimService(slots=traffic["slots"], device=dev)
    loop = ClosedLoop(svc, geometry, cfg, traffic, seed)
    loop.submit(traffic["warm_budget"])       # builds the engine, a seat and a finish
    while not svc.finished:
        svc.step(1)
    for client in range(traffic["clients"]):
        loop.submit_next(client)
    steps = max(1, round(seconds * traffic["service_steps_per_s"]))
    summary = traced = None
    if trace:
        finishes = []

        def traced_steps():
            before = len(svc.finished)
            loop.steps(traffic["trace_steps"])
            finishes.append(len(svc.finished) - before)

        summary = profile_segment(traced_steps, lambda: loop.steps(2), traffic["trace_steps"])
        traced = finishes[0]              # the annotated run's, which the spans cover
        log(f"[trace] sessions finished in the two profiled runs: {finishes}; "
            f"{len(summary.spans)} spans")
    h.sync(dev)
    peak = h.peak_bytes(dev)
    h.reset_peak(dev)
    done0 = loop.steps_done()
    loop.submit_s, loop.submitted = 0.0, 0
    with h.HostMeter() as host:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        loop.steps(steps)
        h.sync(dev)
        window_s = time.perf_counter() - t0
    log(host.line)
    peak = max(peak, h.peak_bytes(dev))
    slot_steps = sum(n - done0.get(sid, 0) for sid, n in loop.steps_done().items())
    submit_s, submitted = loop.submit_s, loop.submitted
    n_fluid = int((geometry != SOLID).sum())
    log(f"[window] {steps} service steps in {window_s:.4f} s; {slot_steps} session steps; "
        f"{loop.submitted} sessions submitted; setup {setup_s:.4f} s; peak {peak} B")

    # ----- the check: the program freed, the reference on its own
    finished = [(s.max_steps, s.result) for s in svc.finished]
    seated = sum(n > done0.get(sid, 0) for sid, n in loop.steps_done().items())
    del svc, loop
    h.free(dev)
    t_ref = time.perf_counter()
    dtype = DTYPES[traffic["dtype"]]
    ref = Reference(geometry, config["physics"], dev, torch.float64)
    ph = config["physics"]
    f = ref.equilibrium(torch.full((ref.n,), float(ph["rho0"]), dtype=torch.float64, device=dev),
                        torch.as_tensor(ph["u0"], dtype=torch.float64, device=dev)[:, None]
                        .expand(3, ref.n)).to(dtype)
    checks = h.Checks(traffic["limits"], at_least=("sessions_finished",))
    checks.add("sessions_finished", len(finished))
    checks.add("session_steps_mismatch", sum(r["steps"] != b for b, r in finished))
    checks.add("session_gap", check_sessions(ref, f, finished))
    log(f"[check] reference {time.perf_counter() - t_ref:.4f} s, "
        f"{max(b for b, _ in finished) if finished else 0} steps, {len(finished)} sessions")

    itemsize = torch.empty((), dtype=dtype).element_size()
    ctx = {"trace": summary, "n_fluid": n_fluid, "itemsize": itemsize,
           "replicas": traffic["slots"], "slots": traffic["slots"],
           "traced_finished": traced,
           "window": {"seconds": window_s, "steps": steps, "slot_steps": slot_steps,
                      "updates": slot_steps * n_fluid, "submit_s": submit_s,
                      "submitted": submitted},
           "measured": {"service_mflups": slot_steps * n_fluid / window_s / 1e6,
                        "setup_s": setup_s}}
    return {"attempted": seated, "failed": 0}, ctx, checks, peak
