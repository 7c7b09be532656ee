"""nebb_ms_per_step — the NEBB pass (``core/backends.py::nebb_boundary_pass``):
device milliseconds of the operations launched under its
``lbm.phase.boundary`` range, per step of the traced segment."""
from lbmbench.readers import scope_ms_per_step

SCOPE = "lbm.phase.boundary"


def read(ctx):
    return scope_ms_per_step(ctx, SCOPE)
