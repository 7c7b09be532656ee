"""The readers of the per-layer metrics, shared by the metric files under
``metrics/`` that name them.  Each takes the run's context (``ctx``: the
measured window, the traced segment's summary and the cell's counts) and
returns a number, or None where it finds nothing to read."""
from __future__ import annotations

from .yardstick import HBM_BYTES_PER_S, eqn10_bytes


def step_eqn10_share(ctx):
    """Percent: Eqn-10 bytes of the window's node updates over its seconds
    and the bandwidth peak."""
    w = ctx["window"]
    if not w["updates"] or w["seconds"] <= 0:
        return None
    return 100.0 * eqn10_bytes(w["updates"], ctx["itemsize"]) / w["seconds"] / HBM_BYTES_PER_S


def kernel_roofline(ctx, kernels, counter):
    """Percent: Eqn-10 bytes of the node updates one launch of the named
    kernels does (every fluid node of every replica) over the launches'
    mean device time and the bandwidth peak.  None unless the trace holds
    one record for each launch the program's ``counter`` counted there: a
    lost or a stray record would shift the mean."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    us = [end - start for start, end, name in trace.ops if any(k in name for k in kernels)]
    if not us or len(us) != trace.launches.get(counter):
        return None
    seconds = sum(us) / len(us) / 1e6
    return (100.0 * eqn10_bytes(ctx["replicas"] * ctx["n_fluid"], ctx["itemsize"])
            / seconds / HBM_BYTES_PER_S)


def device_ops_per_step(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.ops:
        return None
    return len(trace.ops) / trace.steps


def device_idle_share(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s


def slot_occupancy(ctx):
    w, slots = ctx["window"], ctx.get("slots")
    if not slots or not w.get("slot_steps"):
        return None
    return w["slot_steps"] / (slots * w["steps"])


def span_self_ms_per_finish(ctx, parent, child):
    """Host milliseconds inside ``parent`` spans that no ``child`` span
    covers, per session the annotated traced run finished."""
    trace, finished = ctx.get("trace"), ctx.get("traced_finished")
    if trace is None or not finished:
        return None
    parents = {s.sid: s for s in trace.spans if s.name == parent}
    if not parents:
        return None
    covered = sum(s.dur_ns for s in trace.spans if s.name == child and s.parent in parents)
    return (sum(s.dur_ns for s in parents.values()) - covered) / 1e6 / finished


def submit_ms_per_session(ctx):
    w = ctx["window"]
    if not w.get("submitted"):
        return None
    return 1e3 * w["submit_s"] / w["submitted"]
