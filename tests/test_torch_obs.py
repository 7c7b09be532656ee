"""``repro_torch.obs`` against ``repro.obs``: the same calls on both give the
same registry snapshot, Prometheus text, JSONL export, span aggregates and
Chrome-trace structure (timestamps and durations aside); the port's
engine, ensemble and service emit the reference's counters and spans; with
device annotations on, every span and step phase is a
``torch.profiler.record_function`` range, and with them off (or the
recorder disabled) a span opens none; an engine's construction has its
``lbm.setup`` spans."""
import contextlib
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as r_obs
from repro.core.engine import LBMConfig as RConfig
from repro.core.engine import SparseTiledLBM as REngine
from repro_torch import obs
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.obs import trace as p_trace


def _exercise(mod):
    """The same instrument calls, on the given obs package's classes."""
    reg = mod.MetricRegistry()
    reg.counter("lbm.step_total").inc(3)
    reg.counter("sim.session.steps_total", sid="1").inc(2)
    reg.counter("sim.session.steps_total", sid="0").inc(5)
    reg.gauge("lbm.step.mflups", case="duct").set(123.5)
    h = reg.histogram("sim.session.queue_wait_steps")
    for v in (0, 1, 3, 7, 50, 2000):
        h.observe(v)
    reg.histogram("custom", buckets=(0.5, 2.0)).observe(1.0)
    off = mod.MetricRegistry(enabled=False)
    off.counter("x").inc(9)
    off.event("y")
    return reg, off


def _without_ts(snapshot):
    return [{k: v for k, v in rec.items() if k != "ts"} for rec in snapshot]


def test_catalogue_and_api_match_reference():
    """The reference's, less its window-MFLUPS gauge (which made the service
    synchronise every step with metrics on, and which nothing read) and
    ``annotation`` (a span is its own profiler range)."""
    want = dict(r_obs.CATALOGUE)
    del want["sim.service.window_mflups"]
    assert obs.CATALOGUE == want
    assert sorted(obs.__all__) == sorted(set(r_obs.__all__) - {"annotation"})


def test_registry_exports_match_reference(tmp_path):
    (p, p_off), (r, r_off) = _exercise(obs), _exercise(r_obs)
    for reg in (p, r):
        reg.event("sim.session.admit", sid=3, slot=1)
    assert _without_ts(p.snapshot()) == _without_ts(r.snapshot())
    assert p.prometheus_text() == r.prometheus_text()
    assert p_off.snapshot() == r_off.snapshot() == [{
        "type": "counter", "name": "x", "labels": {}, "value": 0.0}]
    p.reset()
    r.reset()
    assert p.snapshot() == r.snapshot()
    lines = [open(reg.write_jsonl(str(tmp_path / f"{i}.jsonl"))).read()
             for i, reg in enumerate((p, r))]
    assert lines[0] == lines[1]
    with pytest.raises(ValueError):
        p.counter("lbm.step_total").inc(-1)
    with pytest.raises(TypeError):
        p.gauge("lbm.step_total")


def _spans(mod):
    rec = mod.SpanRecorder()
    with rec.span("sim.service.step", steps=2):
        for _ in range(2):
            with rec.span("sim.group.step", group="ab12cd34", occupied=2):
                with rec.span("lbm.ensemble.step", batch=2, steps=1):
                    pass
    with rec.span("ckpt.save", step=0):
        pass
    return rec


def _structure(trace: dict):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "tid")}
            for ev in trace["traceEvents"]]


def test_spans_and_chrome_trace_match_reference(tmp_path):
    p, r = _spans(obs), _spans(r_obs)
    assert {k: v["count"] for k, v in p.aggregate().items()} \
        == {k: v["count"] for k, v in r.aggregate().items()}
    assert [(s.sid, s.parent, s.name, s.attrs) for s in p.spans] \
        == [(s.sid, s.parent, s.name, s.attrs) for s in r.spans]
    assert _structure(p.chrome_trace()) == _structure(r.chrome_trace())
    saved = json.load(open(p.save(str(tmp_path / "t.json"))))
    assert _structure(saved) == _structure(p.chrome_trace())
    assert not obs.SpanRecorder(enabled=False).span("x").__enter__()


def test_globals_start_disabled_and_use_restores():
    assert not obs.get_metrics().enabled and not obs.get_tracer().enabled
    reg, rec = obs.MetricRegistry(), obs.SpanRecorder()
    with obs.use(metrics=reg, trace=rec):
        assert obs.get_metrics() is reg and obs.get_tracer() is rec
    assert obs.get_metrics() is not reg


def test_device_annotations_are_record_function():
    assert p_trace.phase_scope("lbm.phase.stream") is p_trace._NULL
    try:
        obs.enable(metrics=False, trace=True)
        assert obs.device_annotations_enabled()
        scope = obs.phase_scope("lbm.phase.stream")
        assert isinstance(scope, torch.profiler.record_function)
        eng = SparseTiledLBM(np.ones((8, 8, 8), np.uint8),
                             LBMConfig(periodic=(True,) * 3,
                                       split_stream=True), device="cpu")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            eng.run(1)
        names = [e.name for e in prof.events()]
        assert names.count("lbm.run") == 1
        assert {"lbm.phase.stream_interior", "lbm.phase.stream_frontier",
                "lbm.phase.collide"} <= set(names)
    finally:
        obs.disable()
    assert not obs.device_annotations_enabled()
    assert isinstance(obs.phase_scope("x"), contextlib.nullcontext)


def _profiled_names(rec, annotations: bool) -> list[str]:
    """The profiler's event names around one span of ``rec``."""
    try:
        obs.set_device_annotations(annotations)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            with rec.span("sim.service.seat", sid=0):
                torch.zeros(2).add_(1.0)
    finally:
        obs.set_device_annotations(False)
    return [e.name for e in prof.events()]


def test_span_opens_a_profiler_range_only_with_annotations_on():
    rec = obs.SpanRecorder()
    assert _profiled_names(rec, True).count("sim.service.seat") == 1
    assert "sim.service.seat" not in _profiled_names(rec, False)
    assert [s.name for s in rec.spans] == ["sim.service.seat"] * 2
    off = obs.SpanRecorder(enabled=False)
    assert "sim.service.seat" not in _profiled_names(off, True)
    assert off.span("x") is p_trace._NULL and off.spans == []


@pytest.mark.parametrize("backend", ["gather", "fused"])
def test_engine_setup_spans(backend):
    rec = obs.SpanRecorder()
    with obs.use(trace=rec):
        SparseTiledLBM(np.ones((8, 8, 8), np.uint8),
                       LBMConfig(backend=backend, periodic=(True,) * 3),
                       device="cpu")
    (setup,) = rec.find("lbm.setup")
    assert setup.attrs == {"backend": backend, "dtype": "float32",
                           "collision": "lbgk", "fluid": "incompressible",
                           "tau": 0.6}
    children = sorted(rec.spans, key=lambda s: s.ts_ns)[1:]
    assert [(s.name, s.parent) for s in children] == [
        (f"lbm.setup.{part}", setup.sid)
        for part in ("tiling", "tables", "kernel_load", "state")]


@pytest.mark.parametrize("backend", ["gather", "fused"])
def test_engine_counters_and_spans_match_reference(backend):
    g = np.ones((8, 8, 8), np.uint8)
    kw = dict(periodic=(True,) * 3, dtype="float64")
    eng = SparseTiledLBM(g, LBMConfig(backend=backend, **kw), device="cpu")
    eng.run(2)                                   # disabled: nothing recorded
    assert obs.get_metrics().value("lbm.step_total") is None
    got, want = [], []
    for mod, build, out in ((obs, lambda: eng, got),
                            (r_obs, lambda: REngine(g, RConfig(**kw)), want)):
        reg, rec = mod.MetricRegistry(), mod.SpanRecorder()
        with jax.enable_x64(True):
            e = build()
        with jax.enable_x64(True), mod.use(metrics=reg, trace=rec):
            e.run(3)
            e.step(2)
            ens = e.ensemble(2)
            ens.step(1)
            ens.run(2)
        out.append((reg.value("lbm.step_total"),
                    [(s.name, s.attrs) for s in rec.spans]))
    # the port's spans add the physics they ran to the reference's attributes
    physics = {"collision": "lbgk", "fluid": "incompressible", "tau": 0.6}
    ((steps, spans),) = got
    assert all({k: a[k] for k in physics} == physics for _, a in spans)
    stripped = [(name, {k: v for k, v in a.items() if k not in physics})
                for name, a in spans]
    assert [(steps, stripped)] == want
    assert got[0][0] == 3 + 2 + 1 + 2
