"""Run one cell of the benchmark once, on the card this process is started on.

    python3 lbmbench/run.py --workload vessel-inflow-f64 --seed 12345 \\
        --seconds 51 --trace 0

From the root of a checkout.  The cell, its configuration and its traffic
are found by name from ``BENCHMARK.json``.  With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiled segment that runs before the measured window.
The last line of standard output is the result (one JSON object); the last
lines of standard error are the numbers compared, each beside its limit.
Without a card, or with fewer than the cell asks for, it prints no result
and exits with 2; if JAX or the JAX package was loaded, with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program builds its CUDA libraries into ``build/repro_torch/`` of the
    checkout by itself), and one thread for the host's numeric libraries:
    the card's work is enqueued by one Python thread, and idle pools only
    add jitter to a host-paced step."""
    cache = ROOT / "build" / "lbmbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from lbmbench import harness as h

    bench = h.load_benchmark()
    cell = h.entry(bench["workloads"], args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"lbmbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)         # both generators take a non-negative seed
    result, checks = h.run_cell(bench, cell, seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_START, log=_log)
    found = h.forbidden_modules()
    if found:
        print(f"lbmbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
