"""What every cell's run shares: loading the benchmark's entries by name,
the program's configuration from a configuration file, the checks and their
limits, the per-layer metric readers, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration file (``configs/<name>.json``) holds the geometry and the
physics, its traffic file (``traffic/<name>.json``) what the run does with
them (a ``kind`` that picks the driver, the precision, the steps or the
sessions, and the limits of the checks), and each per-layer metric is a
reader ``metrics/<name>.py`` with a ``read(ctx)`` that returns a number or
None.  A metric ``<base>.<variant>`` (the same quantity in cells that report
another end-to-end metric, such as ``k1_roofline.service``) is read by
``metrics/<base>.py`` unless a file of its own name exists.  Adding a cell,
a mix or a metric adds files and entries only.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from .reference import COLLISIONS, FLUIDS

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------------ entries
def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(entries: list, name: str) -> dict:
    (found,) = [e for e in entries if e["name"] == name]
    return found


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / entry(bench["configs"], name)["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metric_path(name: str) -> Path | None:
    """The reader file of metric ``name``: ``metrics/<name>.py``, else that
    of the part of the name before its first dot; None where neither exists."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return path
    return None


def metric_reader(name: str):
    """The ``read`` function of metric ``name``'s reader file."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "lbmbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``bench[kind]`` that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------- program
def lbm_config(config: dict, dtype: str):
    """The program's ``LBMConfig`` of a configuration file, in ``dtype``."""
    from repro_torch.core import collision as col
    from repro_torch.core.boundary import BoundarySpec
    from repro_torch.core.engine import LBMConfig

    ph = config["physics"]
    for key, known in (("lattice", ("D3Q19",)), ("collision", COLLISIONS), ("fluid", FLUIDS)):
        if ph[key] not in known:
            raise ValueError(f"the reference has no {key} {ph[key]!r}; it has {', '.join(known)}")
    return LBMConfig(
        lattice="D3Q19", a=config["tile_edge"], layout_scheme="xyz", backend="fused",
        collision=col.CollisionConfig(model=ph["collision"], fluid=ph["fluid"], tau=ph["tau"]),
        dtype=dtype, periodic=tuple(ph["periodic"]),
        force=None if ph["force"] is None else tuple(ph["force"]),
        rho0=ph["rho0"], u0=tuple(ph["u0"]),
        boundaries=tuple((bc["node_type"], BoundarySpec(
            bc["kind"], tuple(bc["normal"]), velocity=tuple(bc.get("velocity", (0, 0, 0))),
            rho=bc.get("rho", 1.0))) for bc in ph["boundaries"]))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_seconds(fn, dev: torch.device) -> float:
    """Seconds ``fn()`` keeps the device busy: CUDA events on the card, the
    host clock on the CPU."""
    if dev.type != "cuda":
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t
    sync(dev)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.init()                 # the allocator's stats exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class HostMeter:
    """What the host did over a window: this process's CPU seconds, its
    context switches, and the machine's load, for the log."""

    @staticmethod
    def _switches() -> tuple[int, int]:
        vol = invol = 0
        try:
            for line in Path("/proc/self/status").read_text().splitlines():
                if line.startswith("voluntary_ctxt_switches"):
                    vol = int(line.split()[1])
                elif line.startswith("nonvoluntary_ctxt_switches"):
                    invol = int(line.split()[1])
        except OSError:
            pass
        return vol, invol

    def __enter__(self):
        self.cpu, self.wall, self.sw = time.process_time(), time.perf_counter(), self._switches()
        return self

    def __exit__(self, *exc):
        cpu, wall = time.process_time() - self.cpu, time.perf_counter() - self.wall
        vol, invol = (b - a for a, b in zip(self.sw, self._switches()))
        try:
            load = Path("/proc/loadavg").read_text().split()[0]
        except OSError:
            load = "?"
        self.line = (f"[host] {cpu:.3f} CPU s in {wall:.3f} s; {vol} voluntary and {invol} "
                     f"involuntary context switches; load average {load}")
        return False


# ------------------------------------------------------------------ checks
class Checks:
    """The numbers compared, each beside its limit: a gap or a count passes
    at or under its limit; a number named in ``at_least`` at or over it.
    NaN passes nothing."""

    def __init__(self, limits: dict, at_least=()):
        self.limits, self.at_least, self.values = limits, set(at_least), {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    def ok(self, name: str) -> bool:
        v, lim = self.values[name], self.limits[name]
        return (v >= lim) if name in self.at_least else (v <= lim)

    @property
    def correct(self) -> bool:
        return all(self.ok(name) for name in self.values)

    def as_dict(self) -> dict:
        return {name: {"value": v, "limit": self.limits[name],
                       "at_least" if name in self.at_least else "at_most": True}
                for name, v in self.values.items()}

    def lines(self) -> list[str]:
        return [f"check {name} = {v!r} ({'>=' if name in self.at_least else '<='} "
                f"{self.limits[name]!r}) {'ok' if self.ok(name) else 'FAILED'}"
                for name, v in self.values.items()]


# ------------------------------------------------------------------ result
def device_entry(dev: torch.device, peak: int, trace=None) -> dict:
    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        out.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return out


def result_line(run: dict, metrics: list[dict], ctx: dict, checks: Checks,
                dev: torch.device, peak: int) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``, the
    metrics the run reports (each read by its reader where the harness has
    not measured it), ``device``, with a trace its ``breakdown``, and the
    checks last."""
    values = {}
    for m in metrics:
        v = ctx["measured"].get(m["name"])
        if v is None and metric_path(m["name"]) is not None:
            v = metric_reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    trace = ctx.get("trace")
    out = {"correct": checks.correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": values,
           "device": device_entry(dev, peak, trace)}
    if trace is not None:
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps}
    out["checks"] = checks.as_dict()
    return out


# --------------------------------------------------------------------- run
def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float, log=print, config: dict | None = None,
             traffic: dict | None = None):
    """One run of ``cell``: its driver (the traffic's ``kind``), then the
    result object and the checks.  ``config`` and ``traffic`` default to
    the cell's files."""
    from . import service, solver
    from .yardstick import HBM_BYTES_PER_S, card_line

    config = config or load_config(bench, cell["config"])
    traffic = traffic or load_traffic(cell["traffic"])
    driver = {"solver": solver.run, "service": service.run}[traffic["kind"]]
    if dev.type == "cuda":
        log(f"[yardstick] bandwidth peak {HBM_BYTES_PER_S:.4g} B/s (H100 SXM data sheet, "
            f"700 W); this card: {card_line()}")
    run, ctx, checks, peak = driver(config, traffic, seed, seconds, trace, dev, t_start, log)
    metrics = cell_metrics(bench, cell["name"], "per_layer" if trace else "end_to_end")
    return result_line(run, metrics, ctx, checks, dev, peak), checks
