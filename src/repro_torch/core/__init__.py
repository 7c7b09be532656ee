"""Solver core: lattice, tiling, stream tables, collision, boundaries,
step backends and the engine."""
