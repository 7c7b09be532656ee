"""The cell ``vessel-inflow-mrt-f64`` (CPU): its configuration is the
large vessel's under LBMRT with the quasi-compressible fluid at tau 0.52,
the program agrees with the plain reference in that physics on the small
vessel (and the float32 control does not), the program's spans name that
physics, and ``k1_mrt_roofline`` reads only K1's MRT quasi-compressible
records of a whole trace under spans that name it."""
import copy

import pytest
import torch

from lbmbench import harness as h
from lbmbench.geometry import make_geometry
from lbmbench.solver import max_gap
from lbmbench.test_lbmbench_reference import program_and_reference
from lbmbench.trace import TraceSummary
from repro_torch.obs.trace import Span

BENCH = h.load_benchmark()
CELL = "vessel-inflow-mrt-f64"
CONFIG = "aneurysm_vessel_large_mrt"
PHYSICS = {"collision": "lbmrt", "fluid": "quasi_compressible", "tau": 0.52}


@pytest.fixture
def small_mrt_vessel(small_vessel):
    """The new configuration's physics on the small vessel's geometry."""
    config = copy.deepcopy(h.load_config(BENCH, CONFIG))
    config["geometry"] = small_vessel["geometry"]
    return config


def test_configuration_is_the_large_vessel_in_another_physics():
    mrt, lbgk = h.load_config(BENCH, CONFIG), h.load_config(BENCH, "aneurysm_vessel_large")
    assert mrt["name"] == CONFIG
    assert {k: mrt["physics"][k] for k in PHYSICS} == PHYSICS
    # a source of its own: the physics' (the rates), within the paper's deployment
    assert mrt["source"] != lbgk["source"] and "arXiv:1611.02445" in mrt["source"]
    (entry,) = [c for c in BENCH["configs"] if c["name"] == CONFIG]
    assert entry["source"] == mrt["source"]
    changed = ("name", "source", "deployment", "source_part", "assumed", "physics")
    assert {k: v for k, v in mrt.items() if k not in changed} == \
        {k: v for k, v in lbgk.items() if k not in changed}
    assert dict(mrt["physics"], **{k: lbgk["physics"][k] for k in PHYSICS}) == lbgk["physics"]
    cfg = h.lbm_config(mrt, "float64").collision
    assert (cfg.model, cfg.fluid, cfg.tau) == tuple(PHYSICS.values())


def test_cell_reports_throughput_and_its_own_layer_metrics():
    (cell,) = [c for c in BENCH["workloads"] if c["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "solver-f64", 1)
    assert {m["name"] for m in h.cell_metrics(BENCH, CELL, "end_to_end")} == {"mflups", "setup_s"}
    assert {m["name"] for m in h.cell_metrics(BENCH, CELL, "per_layer")} == {
        "step_eqn10_share.mrt", "k1_mrt_roofline", "nebb_kernel_ms_per_step.mrt",
        "device_idle_share.mrt"}


def test_reference_agrees_with_program_in_the_cell_physics(small_mrt_vessel, solver_traffic):
    out, solid, ref, ctl = program_and_reference(small_mrt_vessel, 2147483931, torch.float32)
    limit = solver_traffic["limits"]["window_gap"]
    assert solid == 0.0
    assert max_gap(out, ref) <= limit / 100
    # the control, float32 in the program's place, fails the float64 limit
    assert max_gap(ctl, ref) > 10 * limit


def test_engine_spans_name_the_cell_physics(small_mrt_vessel):
    from repro_torch import obs
    from repro_torch.core.engine import SparseTiledLBM

    rec = obs.SpanRecorder()
    with obs.use(trace=rec):
        eng = SparseTiledLBM(make_geometry(small_mrt_vessel["geometry"]),
                             h.lbm_config(small_mrt_vessel, "float64"), device="cpu")
        eng.run(1)
    (setup,) = rec.find("lbm.setup")
    (run,) = rec.find("lbm.run")
    assert {k: setup.attrs[k] for k in PHYSICS} == PHYSICS
    assert run.attrs == {"steps": 1, **PHYSICS}


MRT = "void repro::stream_collide_kernel<double, 19, 0, true, true, false>(double const*, int)"
LBGK = "void repro::stream_collide_kernel<double, 19, 0, false, false, false>(double const*, int)"
MRT_INCOMPRESSIBLE = "void repro::stream_collide_kernel<double, 19, 0, true, false, false>(int)"
NEBB = "void repro::nebb_pass_kernel<double, 19, true, true, false>(double const*, int)"


def _ctx(names, launches, runs):
    """A segment of 0.5 ms records of ``names``, ``launches`` K1 launches
    counted, and ``lbm.run`` spans with ``runs``' attributes."""
    ops = [(1000.0 * i, 1000.0 * i + 500.0, name) for i, name in enumerate(names)]
    spans = [Span(i, -1, "lbm.run", ts_ns=i, dur_ns=1, tid=0, attrs=dict(a))
             for i, a in enumerate(runs)]
    trace = TraceSummary(steps=4, window_s=0.004, busy_s=0.002, ops=ops, scope_s={},
                         spans=spans, idle_gaps=[],
                         launches={"stream_collide_tiles": launches})
    return {"trace": trace, "n_fluid": 10**6, "itemsize": 8, "replicas": 1}


# 1e6 f64 node updates a launch: 2 * 19 * 8 B each in 0.5 ms against 3.35e12 B/s
WHOLE = 100.0 * 2 * 19 * 8 * 1e6 / 500e-6 / 3.35e12
RUN = {"steps": 200, **PHYSICS}


@pytest.mark.parametrize("names,launches,runs,want", [
    ([MRT] * 4 + [NEBB] * 4, 4, [RUN], WHOLE),
    ([MRT.replace("double", "float", 1)] * 4, 4, [RUN, RUN], WHOLE),
    ([LBGK] * 4, 4, [RUN], None),
    ([MRT_INCOMPRESSIBLE] * 4, 4, [RUN], None),
    ([MRT] * 3, 4, [RUN], None),
    ([MRT] * 5, 4, [RUN], None),
    ([MRT] * 4 + [LBGK], 5, [RUN], None),
    ([MRT] * 4, 4, [dict(RUN, collision="lbgk", fluid="incompressible")], None),
    ([MRT] * 4, 4, [RUN, dict(RUN, fluid="incompressible")], None),
    ([MRT] * 4, 4, [{"steps": 200}], None),
    ([MRT] * 4, 4, [], None),
    ([], 0, [RUN], None)],
    ids=["whole", "float", "lbgk-records", "mrt-incompressible-records", "lost", "stray",
         "lbgk-beside", "lbgk-spans", "one-span-other", "spans-without-physics", "no-spans",
         "nothing"])
def test_k1_mrt_roofline_reads_only_mrt_quasi_under_its_spans(names, launches, runs, want):
    read = h.metric_reader("k1_mrt_roofline")(_ctx(names, launches, runs))
    assert read == (None if want is None else pytest.approx(want))

