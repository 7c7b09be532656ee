"""The plain reference against the program's CPU path, and the control
(the reference a precision lower in the program's place) against the
limits (CPU, small geometries), in every collision and fluid model the
reference has."""
import copy

import numpy as np
import pytest
import torch

from lbmbench import harness as h
from lbmbench.geometry import SOLID, make_geometry
from lbmbench.layout import PortLayout
from lbmbench.reference import Reference, fluid_nodes, seeded_state
from lbmbench.service import check_sessions
from lbmbench.solver import max_gap

CPU = torch.device("cpu")
STEPS = 4


def with_physics(config, collision, fluid):
    config = copy.deepcopy(config)
    config["physics"].update(collision=collision, fluid=fluid)
    return config


def program_and_reference(config, seed, dtype=torch.float64, ref_config=None):
    """The program's state after STEPS steps from the seeded state, the
    reference's (of ``ref_config``'s physics where given), and a reference
    of ``dtype``'s (the control's)."""
    from repro_torch.core.engine import SparseTiledLBM

    geometry = make_geometry(config["geometry"])
    eng = SparseTiledLBM(geometry, h.lbm_config(config, "float64"), device=CPU)
    g = torch.as_tensor(geometry)
    coords, index = fluid_nodes(g)
    layout = PortLayout(g, index, eng.tiling.node_coords(), eng.tiling.node_types)
    assert layout.faults == 0 and layout.n_nodes == eng.tiling.n_fluid_nodes
    f0 = seeded_state(len(coords), CPU, seed, 1e-3, 1e-3)
    eng.f = eng.backend.initial_state(layout.pack(f0))
    eng.run(STEPS)
    out, solid = layout.unpack(eng.backend.canonical(eng.f))
    physics = (ref_config or config)["physics"]
    ref = Reference(geometry, physics, CPU).run(f0, STEPS)
    ctl = Reference(geometry, physics, CPU, dtype).run(f0, STEPS)
    return out, solid, ref, ctl


@pytest.mark.parametrize("name", ["small_vessel", "small_pack"])
def test_reference_agrees_with_program(name, request, solver_traffic):
    out, solid, ref, ctl = program_and_reference(request.getfixturevalue(name), 2147483900,
                                                 torch.float32)
    limit = solver_traffic["limits"]["window_gap"]
    assert solid == 0.0
    assert max_gap(out, ref) <= limit / 100
    # the control, float32 in the program's place, fails the float64 limit
    assert max_gap(ctl, ref) > 10 * limit


@pytest.mark.parametrize("name", ["small_vessel", "small_pack"])
@pytest.mark.parametrize("collision,fluid", [("lbgk", "quasi_compressible"),
                                             ("lbmrt", "incompressible"),
                                             ("lbmrt", "quasi_compressible")])
def test_reference_agrees_with_program_in_each_physics(collision, fluid, name, request,
                                                       solver_traffic):
    config = with_physics(request.getfixturevalue(name), collision, fluid)
    out, solid, ref, ctl = program_and_reference(config, 2147483911, torch.float32)
    limit = solver_traffic["limits"]["window_gap"]
    assert solid == 0.0
    assert max_gap(out, ref) <= limit / 100
    assert max_gap(ctl, ref) > 10 * limit


@pytest.mark.parametrize("program,reference", [
    (("lbmrt", "incompressible"), ("lbgk", "incompressible")),
    (("lbgk", "quasi_compressible"), ("lbgk", "incompressible"))], ids=["mrt", "quasi"])
def test_reference_in_another_physics_fails_the_limit(program, reference, small_vessel,
                                                      solver_traffic):
    """A program that runs another collision or fluid model than the
    reference's reads past the limit."""
    out, _, ref, _ = program_and_reference(with_physics(small_vessel, *program), 2147483912,
                                           ref_config=with_physics(small_vessel, *reference))
    assert max_gap(out, ref) > solver_traffic["limits"]["window_gap"]


@pytest.mark.parametrize("fluid", ["incompressible", "quasi_compressible"])
def test_mrt_with_every_rate_one_over_tau_is_lbgk(fluid, small_pack, monkeypatch):
    from lbmbench import reference

    geometry = make_geometry(small_pack["geometry"])
    physics = with_physics(small_pack, "lbmrt", fluid)["physics"]
    f0 = seeded_state(int((geometry != SOLID).sum()), CPU, 5, 1e-3, 1e-3)
    monkeypatch.setattr(reference, "mrt_rates", lambda tau: np.full(19, 1.0 / tau))
    mrt = Reference(geometry, physics, CPU)
    lbgk = Reference(geometry, dict(physics, collision="lbgk"), CPU)
    assert max_gap(mrt.run(f0, 3), lbgk.run(f0, 3)) <= 1e-14


@pytest.mark.parametrize("collision", ["lbgk", "lbmrt"])
@pytest.mark.parametrize("fluid", ["incompressible", "quasi_compressible"])
def test_lbm_config_passes_the_physics(collision, fluid, small_vessel):
    cfg = h.lbm_config(with_physics(small_vessel, collision, fluid), "float64").collision
    assert (cfg.model, cfg.fluid, cfg.tau) == (collision, fluid, small_vessel["physics"]["tau"])


@pytest.mark.parametrize("key,value", [("lattice", "D2Q9"), ("collision", "trt"),
                                       ("fluid", "compressible")])
def test_lbm_config_refuses_what_the_reference_lacks(key, value, small_vessel):
    config = copy.deepcopy(small_vessel)
    config["physics"][key] = value
    with pytest.raises(ValueError, match=f"{key} '{value}'"):
        h.lbm_config(config, "float64")


def test_vessel_reference_rebuilds_open_boundaries(small_vessel):
    """The inlet and outlet nodes differ from plain bounce-back streaming:
    dropping the rebuild moves them past the limit."""
    geometry = make_geometry(small_vessel["geometry"])
    physics = dict(small_vessel["physics"], boundaries=[])
    f0 = seeded_state(int((geometry != SOLID).sum()), CPU, 3, 1e-3, 1e-3)
    ref = Reference(geometry, small_vessel["physics"], CPU).run(f0, 2)
    bare = Reference(geometry, physics, CPU).run(f0, 2)
    assert max_gap(bare, ref) > 1e-3


def test_service_control_fails_the_limit(small_vessel, service_traffic):
    geometry = make_geometry(small_vessel["geometry"])
    ref = Reference(geometry, small_vessel["physics"], CPU)
    ctl = Reference(geometry, small_vessel["physics"], CPU, torch.float32)
    f0 = ref.equilibrium(torch.ones(ref.n, dtype=torch.float64),
                         torch.zeros((3, ref.n), dtype=torch.float64))
    points = np.argwhere(geometry != SOLID)[::97][:4]
    finished, f = [], f0.to(torch.float32)
    for budget in (4, 9):
        f = ctl.run(f, budget - (4 if budget == 9 else 0))
        rho, u = ctl.macroscopics(f.double())
        speed = (u * u).sum(dim=0).sqrt()
        idx = ref.index[points[:, 0], points[:, 1], points[:, 2]]
        finished.append((budget, {
            "steps": budget, "mass": float(f.double().sum()), "mean_speed": float(speed.mean()),
            "max_speed": float(speed.max()),
            "probes": [{"point": list(p), "rho": float(rho[i]), "u": u[:, i].tolist()}
                       for p, i in zip(points, idx)]}))
    assert check_sessions(ref, f0, finished) > 10 * service_traffic["limits"]["session_gap"]
