"""Train a ~100M-param LM for a few hundred steps on the synthetic stream
and watch the loss fall — the end-to-end training driver (the PyTorch
port).

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200   # on the card
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 2 --seq 64

Uses a scaled-down starcoder2-family config (~100M params) with the full
production substrate: AdamW + cosine schedule, checkpointed train step,
checkpointing, watchdog.  Same launcher handles the full configs on a
(data, model) mesh of cards (``--data``/``--model``).
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    args = sys.argv[1:] or []
    defaults = ["--arch", "starcoder2-3b", "--smoke100m",
                "--steps", "200", "--batch", "8", "--seq", "512",
                "--log-every", "20"]
    main(defaults + args)
