"""Fault-tolerance shims: preemption handling, step watchdog, elastic plan
(a copy of the reference's ``repro.dist.ft``; pure Python).

These are deliberately host-side and dependency-free — the launcher polls
them between steps, so a straggling or preempted worker never blocks the
step itself.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import statistics


class PreemptionHandler:
    """Flips ``requested`` when the host receives a preemption signal.

    The training loop checks ``requested`` after each step and performs an
    emergency checkpoint + clean exit (see ``repro_torch.launch.train``).
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._installed = []
        for s in signals:
            try:
                prev = signal.signal(s, self._on_signal)
                self._installed.append((s, prev))
            except (ValueError, OSError):
                # not the main thread / unsupported platform: manual
                # request() still works
                pass

    def _on_signal(self, signum, frame):
        self._requested = True

    def request(self) -> None:
        """Manually request a graceful stop (tests, external schedulers)."""
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested


@dataclasses.dataclass(frozen=True)
class StepReport:
    step: int
    seconds: float
    ratio: float          # seconds / median of recent healthy steps
    is_straggler: bool


class StepWatchdog:
    """Flags steps that take ``threshold``x the recent median step time.

    Straggler steps are excluded from the baseline window so a single slow
    step does not inflate the threshold for its successors.

    When the global :mod:`repro_torch.obs` registry is enabled (or a registry is
    passed explicitly), every observation lands in
    ``dist.watchdog.step_seconds`` and straggler trips are recorded both
    as the ``dist.watchdog.straggler_total`` counter and a
    ``dist.watchdog.straggler`` event carrying (step, seconds, ratio).
    """

    def __init__(self, window: int = 10, threshold: float = 2.0,
                 metrics=None):
        self.window = window
        self.threshold = threshold
        self.metrics = metrics
        self._times: collections.deque = collections.deque(maxlen=window)

    def observe(self, step: int, seconds: float) -> StepReport:
        if self._times:
            base = statistics.median(self._times)
            ratio = seconds / base if base > 0 else 1.0
        else:
            ratio = 1.0
        straggler = bool(ratio >= self.threshold)
        if not straggler:
            self._times.append(seconds)
        reg = self.metrics
        if reg is None:
            from repro_torch import obs
            reg = obs.get_metrics()
        if reg.enabled:
            reg.gauge("dist.watchdog.step_seconds").set(seconds)
            if straggler:
                reg.counter("dist.watchdog.straggler_total").inc()
                reg.event("dist.watchdog.straggler", step=step,
                          seconds=seconds, ratio=ratio)
        return StepReport(step=step, seconds=seconds, ratio=ratio,
                          is_straggler=straggler)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_dp: int
    new_dp: int
    global_batch: int
    step: int
    batch_per_shard: int


def elastic_plan(old_dp: int, new_dp: int, global_batch: int,
                 step: int) -> ElasticPlan:
    """Re-plan the data-parallel layout after losing/gaining workers.

    The global batch is kept constant (training dynamics unchanged); it must
    divide evenly over the surviving shards.
    """
    assert new_dp > 0 and global_batch % new_dp == 0, (
        f"global batch {global_batch} not divisible over {new_dp} shards")
    return ElasticPlan(old_dp=old_dp, new_dp=new_dp,
                       global_batch=global_batch, step=step,
                       batch_per_shard=global_batch // new_dp)


__all__ = ["ElasticPlan", "PreemptionHandler", "StepReport", "StepWatchdog",
           "elastic_plan"]
