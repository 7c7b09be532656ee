"""The benchmark's entries load by name, and what the harness and the
reference import (CPU)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from lbmbench import harness as h

ROOT = Path(__file__).resolve().parents[1]
BENCH = h.load_benchmark()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_loads_by_name(cell):
    config = h.load_config(BENCH, cell["config"])
    traffic = h.load_traffic(cell["traffic"])
    assert config["name"] == cell["config"]
    assert traffic["kind"] in ("solver", "service")
    assert set(traffic["limits"]) >= {"session_gap"} or set(traffic["limits"]) >= {
        "start_gap", "window_gap", "solid_max", "layout_faults"}
    reported = {m["name"] for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in reported and len(reported) >= 2


@pytest.mark.parametrize("path", sorted((ROOT / "lbmbench" / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_file_loads(path):
    traffic = h.load_traffic(path.stem)
    assert traffic["dtype"] in ("float64", "float32") and traffic["limits"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_loads_and_reads_nothing_from_nothing(metric):
    read = h.metric_reader(metric["name"])
    empty = {"trace": None, "window": {"updates": 0, "seconds": 0.0, "steps": 0},
             "n_fluid": 0, "itemsize": 8, "replicas": 1, "measured": {}}
    assert read(empty) is None


def test_configs_name_their_generators():
    from lbmbench.geometry import GENERATORS

    for entry in BENCH["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["geometry"]["generator"] in GENERATORS
        assert config["reduced"] == entry["reduced"]


def _modules_after(imports: str) -> set[str]:
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]; {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    loaded = _modules_after(
        "import lbmbench.run, lbmbench.harness as h, lbmbench.solver, lbmbench.service, "
        "lbmbench.calibrate, repro_torch.core.engine, repro_torch.sim.service; "
        "[h.metric_reader(m['name']) for m in h.load_benchmark()['per_layer']]")
    assert not loaded & set(h.FORBIDDEN), loaded & set(h.FORBIDDEN)
    assert "repro_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import lbmbench.reference, lbmbench.geometry")
    assert not loaded & (set(h.FORBIDDEN) | {"repro_torch"})


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "lbmbench/run.py", "--workload", "vessel-inflow-f64",
                           "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2 and proc.stdout == ""
