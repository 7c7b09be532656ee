"""The plain reference against the program's CPU path, and the control
(the reference a precision lower in the program's place) against the
limits (CPU, small geometries)."""
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


def program_and_reference(config, seed, dtype=torch.float64):
    """The program's state after STEPS steps from the seeded state, the
    reference's, and a reference of ``dtype``'s (the control's)."""
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
    ref = Reference(geometry, config["physics"], CPU).run(f0, STEPS)
    ctl = Reference(geometry, config["physics"], CPU, dtype).run(f0, STEPS)
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
