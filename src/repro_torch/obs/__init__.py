"""``repro_torch.obs`` — observability for the port: the JAX package's
metric registry and span recorder, with the same names and export formats.

Public API (everything else is implementation detail):

* :func:`get_metrics` / :func:`get_tracer` — the process-global
  :class:`~repro_torch.obs.metrics.MetricRegistry` and
  :class:`~repro_torch.obs.trace.SpanRecorder`.  Both start **disabled**:
  every ``inc``/``set``/``observe``/``span`` call on a disabled instance is
  an early-return no-op, so instrumented code costs one attribute check
  when observability is off.  Nothing here synchronises with the card.
* :func:`enable` / :func:`disable` — flip the global switches.
  ``enable(trace=True)`` also turns on device annotations
  (``torch.profiler.record_function`` ranges around the step phases)
  unless overridden with ``device_annotations=False``.
* :func:`use` — context manager that swaps in caller-owned registry /
  recorder instances (and restores the previous ones on exit), so tests
  can collect into private instances without touching global state.

Instrumented code reads the globals at *call* time::

    from repro_torch import obs
    reg = obs.get_metrics()
    if reg.enabled:
        reg.counter("lbm.step_total").inc(steps)

Metric names are catalogued in :data:`repro_torch.obs.metrics.CATALOGUE`.
"""
from __future__ import annotations

import contextlib

from .metrics import (CATALOGUE, Counter, Gauge, Histogram,
                               MetricRegistry)
from .trace import (Span, SpanRecorder, annotation,
                             device_annotations_enabled, phase_scope,
                             set_device_annotations)

_metrics = MetricRegistry(enabled=False)
_tracer = SpanRecorder(enabled=False)


def get_metrics() -> MetricRegistry:
    return _metrics


def get_tracer() -> SpanRecorder:
    return _tracer


def enable(metrics: bool = True, trace: bool = True,
           device_annotations: bool | None = None) -> None:
    """Turn the global collectors on.  ``device_annotations`` defaults to
    following ``trace``."""
    _metrics.enabled = metrics
    _tracer.enabled = trace
    set_device_annotations(
        trace if device_annotations is None else device_annotations)


def disable() -> None:
    _metrics.enabled = False
    _tracer.enabled = False
    set_device_annotations(False)


@contextlib.contextmanager
def use(metrics: MetricRegistry | None = None,
        trace: SpanRecorder | None = None):
    """Temporarily route global obs lookups to caller-owned instances::

        reg, rec = MetricRegistry(), SpanRecorder()
        with obs.use(metrics=reg, trace=rec):
            eng.run(100)          # instrumentation lands in reg/rec

    Only the arguments given are swapped; previous instances (and their
    enabled state) are restored on exit, even on exceptions.
    """
    global _metrics, _tracer
    prev_m, prev_t = _metrics, _tracer
    if metrics is not None:
        _metrics = metrics
    if trace is not None:
        _tracer = trace
    try:
        yield
    finally:
        _metrics, _tracer = prev_m, prev_t


__all__ = [
    "CATALOGUE", "Counter", "Gauge", "Histogram", "MetricRegistry",
    "Span", "SpanRecorder", "annotation", "device_annotations_enabled",
    "disable", "enable", "get_metrics", "get_tracer", "phase_scope",
    "set_device_annotations", "use",
]
