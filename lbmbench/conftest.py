"""Small cells for the benchmark's CPU tests: the configurations' physics on
geometries a test run can hold."""
import copy

import pytest

from lbmbench import harness as h

BENCH = h.load_benchmark()


def small(config_name: str, geometry: dict) -> dict:
    config = copy.deepcopy(h.load_config(BENCH, config_name))
    config["geometry"] = geometry
    return config


@pytest.fixture
def small_vessel():
    return small("aneurysm_vessel", {"generator": "vessel_aneurysm", "shape": [64, 48, 48],
                                     "radius": 8.0, "bulge": 12.0})


@pytest.fixture
def small_pack():
    return small("sphere_pack", {"generator": "random_spheres", "box": 32, "porosity": 0.7,
                                 "diameter": 16, "seed": 0})


@pytest.fixture
def solver_traffic():
    traffic = h.load_traffic("solver-f64")
    traffic.update(rate_steps=2)
    return traffic


@pytest.fixture
def service_traffic():
    traffic = h.load_traffic("service-closed6-f64")
    traffic.update(slots=2, clients=3, budget_min=4, budget_max=9, service_steps_per_s=400)
    return traffic


@pytest.fixture(autouse=True)
def one_thread():
    """The small cells run on one thread: the suite's workers share the
    machine's cores, and torch's thread pool in each of them only contends."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
