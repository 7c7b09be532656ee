"""The readers of the service's span metrics and of K1's roofline on a
hand-made traced segment: known spans, device time under their ranges and
device records give known numbers (CPU)."""
import pytest

from lbmbench import harness as h
from lbmbench.trace import TraceSummary
from repro_torch.obs.trace import Span


def _span(sid, parent, name, ms):
    return Span(sid, parent, name, ts_ns=sid, dur_ns=int(ms * 1e6), tid=0)


def _ctx(spans, scope_s, finished=2):
    trace = TraceSummary(steps=10, window_s=1.0, busy_s=0.5, ops=[], scope_s=scope_s,
                         spans=spans, idle_gaps=[])
    return {"trace": trace, "traced_finished": finished}


# two sessions: each keyed in its submit and at its admission; 3 seats (one
# of a session that has not finished) and 2 finishes under two service steps
SPANS = [_span(0, -1, "sim.service.submit", 130.0), _span(1, 0, "sim.registry.key", 100.0),
         _span(2, -1, "sim.service.submit", 140.0), _span(3, 2, "sim.registry.key", 110.0),
         _span(4, -1, "sim.service.step", 300.0), _span(5, 4, "sim.registry.key", 95.0),
         _span(6, 4, "sim.service.seat", 1.0), _span(7, 4, "sim.service.seat", 1.0),
         _span(8, -1, "sim.service.step", 200.0), _span(9, 8, "sim.registry.key", 105.0),
         _span(10, 8, "sim.service.seat", 1.0), _span(11, 8, "sim.service.finish", 2.0),
         _span(12, 8, "sim.service.finish", 2.0)]
SCOPE_S = {"sim.service.seat": 0.0066, "sim.service.finish": 0.0124,
           "sim.service.step": 0.05}


WANT = {"service_key_ms_per_session": (100.0 + 110.0 + 95.0 + 105.0) / 2,
        "service_seat_device_ms": 6.6 / 3,
        "service_finish_device_ms": 12.4 / 2}


@pytest.mark.parametrize("metric", WANT)
def test_span_metric_reads_its_spans(metric):
    assert h.metric_reader(metric)(_ctx(SPANS, SCOPE_S)) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", WANT)
def test_span_metric_reads_nothing_without_its_spans(metric):
    """A program that records none of these spans gives no reading rather
    than a zero."""
    others = [s for s in SPANS if s.name in ("sim.service.step", "sim.service.submit")]
    assert h.metric_reader(metric)(_ctx(others, {"sim.service.step": 0.05})) is None


def test_key_metric_reads_nothing_without_a_finished_session():
    assert h.metric_reader("service_key_ms_per_session")(_ctx(SPANS, SCOPE_S, finished=0)) is None


def _k1_ctx(records, launches):
    ops = [(1000.0 * i, 1000.0 * i + 500.0, "void repro::stream_collide_kernel<double>")
           for i in range(records)]
    trace = TraceSummary(steps=4, window_s=0.004, busy_s=0.002, ops=ops, scope_s={}, spans=[],
                         idle_gaps=[], launches={"stream_collide_tiles": launches})
    return {"trace": trace, "n_fluid": 10**6, "itemsize": 8, "replicas": 1}


# 1e6 f64 node updates a launch: 2 * 19 * 8 B each in 0.5 ms against 3.35e12 B/s
WHOLE = 100.0 * 2 * 19 * 8 * 1e6 / 500e-6 / 3.35e12


@pytest.mark.parametrize("records,want", [(4, WHOLE), (3, None), (5, None)],
                         ids=["whole", "lost", "stray"])
def test_k1_roofline_reads_only_a_whole_trace(records, want):
    """Four launches counted: four 0.5 ms records read their share; a lost
    or a stray record reads nothing."""
    read = h.metric_reader("k1_roofline")(_k1_ctx(records, 4))
    assert read == (None if want is None else pytest.approx(want))
