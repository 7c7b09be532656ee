"""Span-based tracing that exports Chrome-trace-event JSON.

Two complementary mechanisms, both behind one switch each:

* **Host spans** (:class:`SpanRecorder`) — a pure-Python recorder.
  ``with rec.span("sim.service.step"):`` measures wall time with
  ``time.perf_counter_ns`` and remembers the parent span (a thread-local
  stack, so ``CheckpointStore.save_async``'s background thread nests
  correctly).  ``chrome_trace()`` emits the Chrome trace-event format
  (``ph: "X"`` complete events, microsecond timestamps), which loads
  directly in https://ui.perfetto.dev or chrome://tracing.

* **Device annotations** (:func:`phase_scope` / :func:`annotation`) —
  when enabled, both wrap their block in
  ``torch.profiler.record_function``, so a ``torch.profiler`` trace names
  the ops each phase launched; when off (the default) both are a shared
  null context.

Host spans measure *enqueue* boundaries: a step returns before the card
has run it, so per-phase device time comes from the profiler (via the
annotations), not from host spans.  Host spans still give the
serving-layer picture (service step > group step > ensemble step >
checkpoint save) that the profiler cannot see.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch

_NULL = contextlib.nullcontext()

# Module-level switch for the record_function wrapping, read at every call.
_DEVICE_ANNOTATIONS = False


def set_device_annotations(on: bool) -> None:
    global _DEVICE_ANNOTATIONS
    _DEVICE_ANNOTATIONS = bool(on)


def device_annotations_enabled() -> bool:
    return _DEVICE_ANNOTATIONS


def phase_scope(name: str):
    """``torch.profiler.record_function(name)`` when device annotations are
    on, else a no-op context.  Wrap the phases of a step with this."""
    if not _DEVICE_ANNOTATIONS:
        return _NULL
    return torch.profiler.record_function(name)


def annotation(name: str):
    """``torch.profiler.record_function(name)`` when device annotations are
    on, else a no-op context.  Wrap whole runs with this."""
    return phase_scope(name)


@dataclass
class Span:
    sid: int
    parent: int          # -1 for roots
    name: str
    ts_ns: int           # start, perf_counter_ns
    dur_ns: int
    tid: int             # recording thread ident
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.dur_ns / 1e9


class _SpanCtx:
    __slots__ = ("_rec", "_name", "_attrs", "_sid", "_parent", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: dict):
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        self._parent = stack[-1] if stack else -1
        with rec._lock:
            self._sid = rec._next_sid
            rec._next_sid += 1
        stack.append(self._sid)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        rec = self._rec
        rec._stack().pop()
        with rec._lock:
            rec.spans.append(Span(self._sid, self._parent, self._name,
                                  self._t0, dur,
                                  threading.get_ident(), self._attrs))
        return False


class SpanRecorder:
    """Collects :class:`Span`s; thread-safe (checkpoint saves run on a
    background thread).  Disabled recorders hand out a shared null
    context — zero allocation on the hot path."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []
        self._next_sid = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, attrs)

    # ----------------------------------------------------------- reads
    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def aggregate(self) -> dict[str, dict]:
        """{name: {"count": n, "seconds": total}} — the per-phase
        breakdown consumed by ``benchmarks.common.TimedRun.phases``."""
        agg: dict[str, dict] = {}
        for s in self.spans:
            a = agg.setdefault(s.name, {"count": 0, "seconds": 0.0})
            a["count"] += 1
            a["seconds"] += s.seconds
        return agg

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self._next_sid = 0

    # ---------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (perfetto / chrome://tracing).

        Every span is a ``ph: "X"`` complete event; span id and parent id
        ride in ``args`` so nesting survives the round-trip even for
        same-timestamp spans."""
        events = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "repro"},
        }]
        for s in sorted(self.spans, key=lambda s: s.ts_ns):
            args = {"sid": s.sid, "parent": s.parent}
            args.update({k: v for k, v in s.attrs.items()})
            events.append({
                "name": s.name, "cat": s.name.split(".")[0], "ph": "X",
                "ts": s.ts_ns / 1e3, "dur": s.dur_ns / 1e3,
                "pid": 1, "tid": s.tid % 100000,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


__all__ = ["Span", "SpanRecorder", "annotation", "phase_scope",
           "set_device_annotations", "device_annotations_enabled"]
