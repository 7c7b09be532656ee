"""The benchmark's frozen yardstick: the card's bandwidth peak and the
paper's minimum traffic of a node update.

Eqn (10) of Tomczak & Szafran (arXiv:1611.02445): one D3Q19 node update
reads and writes its 19 values once, 2 * 19 * sizeof(dtype) bytes; the
solid nodes a tile also carries are not counted.  The peak is NVIDIA's data
sheet figure for the H100 SXM (80 GB HBM3) at its full 700 W.
"""
from __future__ import annotations

import subprocess

Q = 19
HBM_BYTES_PER_S = 3.35e12


def eqn10_bytes(node_updates: float, itemsize: int) -> float:
    """The paper's minimum bytes of ``node_updates`` D3Q19 node updates."""
    return 2.0 * Q * itemsize * node_updates


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, for
    the line that prints the peak."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc.__class__.__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
