"""repro_torch — the sparse tiled LBM solver on PyTorch and CUDA (Hopper).

The port of the JAX package ``repro``, which stays beside it as the
reference.  The port imports neither JAX nor ``repro``: it keeps its own
copies of the host-side numpy code.  Its kernels are hand-written CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).
"""
