"""The torch twins of the four example scripts (``examples/torch/``) run
with ``--device cpu`` at a small size, in a subprocess each (as a user runs
them), print their originals' lines and end on finite numbers, and have
loaded neither jax nor the reference package by their end."""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# runs a script as __main__, then lists the jax / reference modules loaded
_RUN = """
import runpy, sys
script, *argv = sys.argv[1:]
sys.argv = [script, *argv]
runpy.run_path(script, run_name="__main__")
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""

# script -> (arguments, a line the original prints too)
RUNS = {
    "quickstart.py": (["--size", "16", "--steps", "20"], r"mass=.* max \|u\|="),
    "sparse_flow.py": (["--steps", "20", "--check-every", "10"], r"MFLUPS"),
    "serve_lm.py": ([], r"served 6 requests"),
    "train_lm.py": (["--steps", "2", "--batch", "2", "--seq", "64", "--layers", "2",
                     "--log-every", "1"], r"final loss"),
}


def _numbers(line: str) -> list[float]:
    return [float(v) for v in re.findall(r"[-+]?(?:\d+\.\d*|\d+|nan|inf)(?:e[-+]?\d+)?",
                                         line.replace(",", ""))]


@pytest.mark.parametrize("script", sorted(RUNS))
def test_example_twin_runs_on_the_cpu(script):
    args, expect = RUNS[script]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _RUN,
                           str(ROOT / "examples" / "torch" / script), "--device", "cpu",
                           *args], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    *lines, loaded = proc.stdout.strip().splitlines()
    assert loaded == "LOADED []", loaded
    assert any(re.search(expect, line) for line in lines), proc.stdout[-2000:]
    last = lines[-1]
    nums = _numbers(last)
    assert nums and all(math.isfinite(v) for v in nums), last

