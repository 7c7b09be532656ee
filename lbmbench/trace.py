"""The traced segment of a ``--trace 1`` run.

``torch.profiler`` records a fixed number of the cell's own steps twice:
once with the host, the program's device annotations (``obs.phase_scope``
ranges) and its host spans switched on, once with the device alone.  A marker kernel opens the segment on
the device's clock: the profiler can place device records against host
ones with an offset of milliseconds, so the segment's device operations
are those that start after the marker.  The reduction keeps what the
per-layer metrics read: the device operations, their busy time, the device
time under each host range (``record_function``), the host spans, the idle gaps with
what the host was doing in them, and how far the program's K1 launch counter
advanced over the segment of the run the device operations come from, so
that a reader can tell a trace that lost a record from a whole one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

WINDOW = "lbmbench.traced_segment"
MARKER_KERNEL = "spin_kernel"          # torch.cuda._sleep's kernel


@dataclasses.dataclass
class TraceSummary:
    steps: int                                  # steps in the segment
    window_s: float      # marker end to last device op end (device-only run)
    busy_s: float        # union of device op intervals (device-only run)
    ops: list            # (start_us, end_us, name), sorted (device-only run)
    scope_s: dict        # device seconds under each host range (annotated run)
    spans: list          # the program's host spans (annotated run)
    idle_gaps: list      # [host activity, seconds], most first (annotated run)
    # launches the program counted in the segment, by its counter's name (the
    # run ``ops`` come from)
    launches: dict = dataclasses.field(default_factory=dict)

    def top_ops(self, k: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        total: dict[str, float] = {}
        for start, end, name in self.ops:
            total[name] = total.get(name, 0.0) + (end - start) / 1e6
        return [[name[:160], s] for name, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def _union_us(ops) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def _idle_gaps(ops, host, start_us, k: int = 10, longest: int = 200) -> list:
    """The device's idle gaps, labelled by the innermost host range or op
    running at each gap's middle ("python" where none is), summed by label
    over the ``longest`` gaps; the ``k`` labels with most idle time."""
    gaps, prev = [], start_us
    for s, e, _ in ops:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    if not gaps:
        return []
    h_start = np.array([h[0] for h in host])
    h_end = np.array([h[1] for h in host])
    total: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        label = host[cover[np.argmax(h_start[cover])]][2] if len(cover) else "python"
        total[label] = total.get(label, 0.0) + (b - a) / 1e6
    return [[name[:160], s] for name, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def _launches() -> dict:
    """The program's launch counters that readers check records against."""
    from repro_torch.kernels.stream_collide import stream_collide_tiles

    return {"stream_collide_tiles": stream_collide_tiles.launches}


def _profile(fn, warm, cpu: bool):
    """``warm()``, then ``fn()`` behind a marker kernel, under
    ``torch.profiler``; its events, the marker's host range (None without
    host activity) and how far each launch counter advanced in ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        warm()
        torch.cuda.synchronize()
        obs.get_tracer().reset()
        before = _launches()
        with record_function(WINDOW):
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in _launches().items()}
    events = prof.events()
    host = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    return (events, (host[0].time_range.start, host[0].time_range.end) if host else None,
            launches)


def _device_ops(events, t0):
    """The device operations after the marker kernel (after the host start
    ``t0`` where the marker's record was lost), and the segment's start."""
    from torch.autograd import DeviceType

    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name != WINDOW
              and not getattr(e, "is_user_annotation", False)]
    marks = [e for _, e, name in device if MARKER_KERNEL in name]
    start = min(marks) if marks else (t0 or 0.0)
    return sorted(op for op in device if op[0] >= start and MARKER_KERNEL not in op[2]), start


def profile_segment(fn, warm, steps: int) -> TraceSummary:
    """Two profiled runs of ``fn()`` (``steps`` of the cell's steps), each
    after ``warm()``.  The first records the host too, with the program's
    annotations and spans on: it gives the device time under each host
    range, the spans and what the host did in the idle gaps.  The second
    records the device alone, so that the profiler's host work does not
    widen the gaps: it gives the device operations, their busy time and the
    segment's length."""
    from torch.autograd import DeviceType

    from repro_torch import obs

    obs.enable(metrics=False, trace=True)
    try:
        events, (t0, t1), launches_a = _profile(fn, warm, cpu=True)
    finally:
        obs.disable()
    spans = list(obs.get_tracer().spans)
    obs.get_tracer().reset()
    ops_a, start_a = _device_ops(events, t0)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name != WINDOW
            and t0 <= e.time_range.start <= t1]
    scope_s: dict[str, float] = {}
    for e in events:
        if ((getattr(e, "is_user_annotation", False) or e.name.startswith("lbm."))
                and e.device_type == DeviceType.CPU
                and e.name != WINDOW and e.time_range.start >= t0):
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            scope_s[e.name] = scope_s.get(e.name, 0.0) + total / 1e6
    idle_gaps = _idle_gaps(ops_a, host, start_a)
    del events, host
    events, _, launches = _profile(fn, warm, cpu=False)
    ops, start = _device_ops(events, None)
    if not ops:
        ops, start, launches = ops_a, start_a, launches_a
    end = max((e for _, e, _ in ops), default=start)
    return TraceSummary(steps=steps, window_s=(end - start) / 1e6,
                        busy_s=_union_us(ops) / 1e6, ops=ops, scope_s=scope_s,
                        spans=spans, idle_gaps=idle_gaps, launches=launches)
