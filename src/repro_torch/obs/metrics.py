"""Lightweight metric registry: counters / gauges / histograms + export.

The port's copy of the JAX package's registry.  One registry holds every
instrument under a STABLE naming scheme (the catalogue below — ``lbm.*``
for the engine, ``sim.*`` for the serving layer, ``dist.*`` for the
multi-device layer, ``ckpt.*`` for the checkpoint store), the same names
the JAX package emits, so the two packages' exports join on the metric
name.

Design constraints:

* **Zero cost when disabled** — every mutation checks one boolean on the
  owning registry and returns.
* **Deterministic export** — ``snapshot()`` orders instruments by
  (name, labels), so exporting twice without intervening mutations yields
  byte-identical JSONL / Prometheus text.
* **Labelled instruments** — ``registry.counter("x", sid="3")`` is a
  distinct time series from ``sid="4"``; labels are plain str->str.

Export formats: JSONL (one instrument per line, ``write_jsonl``) and the
Prometheus text exposition format (``prometheus_text``).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

# Catalogue of the stable metric names (name -> what it measures), as the
# JAX package's.
CATALOGUE = {
    # ---- engine (per step / per run) ---------------------------------
    "lbm.step_total": "counter: LBM iterations dispatched",
    "lbm.step.mflups": "gauge: measured kernel-only MFLUPS (fori_loop run)",
    "lbm.step.mflups_dispatch": "gauge: MFLUPS with one jit call per step",
    "lbm.step.seconds": "gauge: measured seconds per step (kernel-only)",
    "lbm.mass.total": "gauge: total fluid mass",
    "lbm.mass.drift": "gauge: |mass - mass0| / mass0 (per session sid)",
    # ---- bandwidth / traffic model (paper Eqn 10) --------------------
    "lbm.bw.achieved_gbs": "gauge: Eqn-10 minimum bytes / measured step s",
    "lbm.bw.eqn10_min_bytes": "gauge: modelled minimum bytes per step "
                              "(2 Q n_fluid dtype_size)",
    "lbm.bw.eqn10_fraction": "gauge: Eqn-10 minimum / modelled actual "
                             "bytes per step (traffic efficiency; higher "
                             "is better)",
    "lbm.bytes.model_per_node": "gauge: modelled bytes per fluid-node "
                                "update (state + index tables)",
    "lbm.index.bytes_per_node": "gauge: indirection-table bytes per "
                                "fluid-node update",
    # ---- streaming structure / data placement ------------------------
    "lbm.stream.interior_frac": "gauge: fraction of links that are "
                                "intra-tile (no per-link index)",
    "lbm.stream.frontier_frac": "gauge: fraction of links crossing tiles",
    "lbm.stream.bounce_frac": "gauge: fraction of links that bounce",
    "lbm.tiles.utilisation": "gauge: fluid nodes / stored nodes (eta_t)",
    # ---- serving layer ------------------------------------------------
    "sim.session.submitted_total": "counter: sessions submitted",
    "sim.session.admitted_total": "counter: sessions seated into slots",
    "sim.session.finished_total": "counter: sessions finished",
    "sim.session.steps_total": "counter: LBM steps run (per session sid)",
    "sim.session.queue_wait_steps": "histogram: service steps a session "
                                    "waited in queue before seating",
    "sim.slot.occupancy": "gauge: occupied/total slots (per group)",
    "sim.service.window_mflups": "gauge: aggregate MFLUPS over the last "
                                 "service step window",
    "sim.node_updates_total": "counter: fluid-node updates served",
    # ---- distributed layer --------------------------------------------
    "dist.halo.bytes": "gauge: halo-exchange bytes per step (all devices)",
    "dist.halo.bytes_total": "counter: cumulative halo-exchange bytes",
    "dist.watchdog.step_seconds": "gauge: last step wall time observed",
    "dist.watchdog.straggler_total": "counter: watchdog straggler trips",
    # ---- checkpoint store ---------------------------------------------
    "ckpt.save_total": "counter: checkpoint saves committed",
    "ckpt.save.bytes_total": "counter: leaf bytes written",
    "ckpt.save.seconds": "gauge: wall seconds of the last save",
    "ckpt.restore_total": "counter: checkpoint restores",
}

_DEFAULT_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value; ``inc`` rejects negative deltas."""

    kind = "counter"

    def __init__(self, registry: "MetricRegistry", name: str, labels: tuple):
        self._reg, self.name, self.labels = registry, name, labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n

    def _reset(self):
        self.value = 0.0

    def _export(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"

    def __init__(self, registry: "MetricRegistry", name: str, labels: tuple):
        self._reg, self.name, self.labels = registry, name, labels
        self.value = 0.0

    def set(self, v: float) -> None:
        if self._reg.enabled:
            self.value = float(v)

    def _reset(self):
        self.value = 0.0

    def _export(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram (cumulative on export, Prometheus-style).

    ``buckets`` are the inclusive upper bounds of each bucket; values above
    the last bound land in the implicit +Inf bucket.
    """

    kind = "histogram"

    def __init__(self, registry: "MetricRegistry", name: str, labels: tuple,
                 buckets=_DEFAULT_BUCKETS):
        self._reg, self.name, self.labels = registry, name, labels
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)      # + the +Inf bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.count += 1
        self.sum += v

    def _reset(self):
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def _export(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "count": self.count, "sum": self.sum}


class MetricRegistry:
    """Instrument factory + store; see the module docstring.

    ``enabled`` is the single switch every mutation checks — flipping it
    off turns every ``inc``/``set``/``observe``/``event`` into an early
    return without touching the instruments (reads keep working).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[tuple, object] = {}
        self._events: list[dict] = []
        self._lock = threading.Lock()

    # ----------------------------------------------------- instruments
    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(self, name, key[1], **kw)
                self._metrics[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(f"{name} already registered as "
                                f"{inst.kind}, not {cls.kind}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets=_DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def event(self, name: str, **attrs) -> None:
        """Append a timestamped point event (admit/evict/trip/...)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                {"name": name, "ts": time.time(), "attrs": attrs})

    # ----------------------------------------------------------- reads
    def value(self, name: str, **labels):
        """Current value of a counter/gauge (None if never registered)."""
        inst = self._metrics.get((name, _label_key(labels)))
        return None if inst is None else inst.value

    def values(self, name: str) -> dict[tuple, float]:
        """{labels: value} across every labelling of ``name``."""
        return {key[1]: inst.value
                for key, inst in self._metrics.items()
                if key[0] == name and hasattr(inst, "value")}

    @property
    def events(self) -> list[dict]:
        return list(self._events)

    def reset(self) -> None:
        """Zero every instrument and drop events (registrations persist,
        so instrument handles held by callers stay valid)."""
        with self._lock:
            for inst in self._metrics.values():
                inst._reset()
            self._events.clear()

    # ---------------------------------------------------------- export
    def snapshot(self) -> list[dict]:
        """Deterministically-ordered export records (metrics then
        events); two snapshots without intervening mutations are equal."""
        out = []
        for (name, labels), inst in sorted(self._metrics.items()):
            rec = {"type": inst.kind, "name": name,
                   "labels": dict(labels)}
            rec.update(inst._export())
            out.append(rec)
        for ev in self._events:
            out.append({"type": "event", "name": ev["name"],
                        "ts": ev["ts"], "attrs": ev["attrs"]})
        return out

    def write_jsonl(self, path: str) -> str:
        """One JSON object per line; parent dirs created."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in self.snapshot():
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (dots become underscores)."""
        lines = []
        seen_type = set()
        for (name, labels), inst in sorted(self._metrics.items()):
            pname = re.sub(r"[^a-zA-Z0-9_]", "_", name)
            if pname not in seen_type:
                lines.append(f"# TYPE {pname} {inst.kind}")
                seen_type.add(pname)
            lab = ",".join(f'{re.sub(r"[^a-zA-Z0-9_]", "_", k)}="{v}"'
                           for k, v in labels)
            if inst.kind == "histogram":
                cum = 0
                for b, c in zip(list(inst.buckets) + ["+Inf"], inst.counts):
                    cum += c
                    blab = lab + ("," if lab else "") + f'le="{b}"'
                    lines.append(f"{pname}_bucket{{{blab}}} {cum}")
                suffix = f"{{{lab}}}" if lab else ""
                lines.append(f"{pname}_sum{suffix} {inst.sum}")
                lines.append(f"{pname}_count{suffix} {inst.count}")
            else:
                suffix = f"{{{lab}}}" if lab else ""
                lines.append(f"{pname}{suffix} {inst.value}")
        return "\n".join(lines) + "\n"


__all__ = ["CATALOGUE", "Counter", "Gauge", "Histogram", "MetricRegistry"]
