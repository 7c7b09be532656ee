"""The benchmark of ``repro_torch``, the paper's sparse tiled LBM on one
card: a data-driven harness (``run.py``), its frozen geometry generators,
yardstick and plain reference, the configurations, traffic mixes and
per-layer metric readers it finds by name from ``BENCHMARK.json``."""
