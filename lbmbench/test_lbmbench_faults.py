"""A whole run of each kind of cell on the CPU at a small size, the chip's
look skipped: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (a step that returns its state unchanged; half of the tiles or of the
batch's replicas left out; an answer altered where it is produced)."""
import time

import pytest
import torch

from lbmbench import harness as h

BENCH = h.load_benchmark()
CPU = torch.device("cpu")


def run(cell: str, config: dict, traffic: dict) -> dict:
    result, _ = h.run_cell(BENCH, h.entry(BENCH["workloads"], cell), 2147483901, 0.05, False,
                           CPU, time.perf_counter(), log=lambda msg: None, config=config,
                           traffic=traffic)
    return result


def test_sound_solver_run(small_vessel, solver_traffic):
    result = run("vessel-inflow-f64", small_vessel, solver_traffic)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"mflups", "setup_s"}
    assert result["attempted"] >= solver_traffic["end_steps"] + 1


def test_sound_service_run(small_vessel, service_traffic):
    result = run("vessel-service-f64", small_vessel, service_traffic)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"service_mflups", "setup_s"}
    assert result["checks"]["sessions_finished"]["value"] >= 2


def _unchanged(orig):
    return lambda self, f, *out: f


def _half_tiles(orig):
    def step(self, f):
        out = orig(self, f)
        t = self.tiling.num_tiles
        out[t // 2:t] = f[t // 2:t]
        return out
    return step


def _altered(orig):
    def step(self, f):
        out = orig(self, f)
        tile, slot = torch.nonzero(self._types[:-1] != 0)[0]
        out[tile, 1, slot] += 1e-6
        return out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_tiles, _altered],
                         ids=["unchanged", "half_tiles", "altered"])
def test_solver_fault_is_caught(fault, monkeypatch, small_vessel, solver_traffic):
    from repro_torch.core.backends import FusedBackend

    monkeypatch.setattr(FusedBackend, "step", fault(FusedBackend.step))
    assert not run("vessel-inflow-f64", small_vessel, solver_traffic)["correct"]


def _half_replicas(orig):
    def ensemble_step(self, f, out):
        out = orig(self, f, out)
        t = self.tiling.num_tiles
        batch = (f.shape[0] - 1) // t
        out[batch // 2 * t:batch * t] = f[batch // 2 * t:batch * t]
        return out
    return ensemble_step


def test_service_fault_is_caught_unchanged(monkeypatch, small_vessel, service_traffic):
    from repro_torch.core.backends import FusedBackend

    monkeypatch.setattr(FusedBackend, "ensemble_step", _unchanged(FusedBackend.ensemble_step))
    assert not run("vessel-service-f64", small_vessel, service_traffic)["correct"]


def test_service_fault_is_caught_half_replicas(monkeypatch, small_vessel, service_traffic):
    from repro_torch.core.backends import FusedBackend

    monkeypatch.setattr(FusedBackend, "ensemble_step", _half_replicas(FusedBackend.ensemble_step))
    assert not run("vessel-service-f64", small_vessel, service_traffic)["correct"]


def test_service_fault_is_caught_altered(monkeypatch, small_vessel, service_traffic):
    from repro_torch.sim.service import SimService

    orig = SimService._finish

    def finish(self, group, slot):
        sess = group.active[slot]
        orig(self, group, slot)
        sess.pending["mass"] = sess.pending["mass"] * (1 + 1e-6)

    monkeypatch.setattr(SimService, "_finish", finish)
    assert not run("vessel-service-f64", small_vessel, service_traffic)["correct"]
