"""Batched serving demo: fixed-slot continuous batching with greedy decode
(the PyTorch port).

    PYTHONPATH=src python examples/torch/serve_lm.py               # on the card
    PYTHONPATH=src python examples/torch/serve_lm.py --device cpu
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--arch", "gemma2-2b", "--smoke", "--requests", "6",
          "--slots", "3", "--prompt-len", "24", "--max-new", "12",
          "--max-len", "64"] + sys.argv[1:])
