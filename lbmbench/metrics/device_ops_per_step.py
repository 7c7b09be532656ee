"""device_ops_per_step — the step loop (``core/engine.py``,
``FusedBackend.step`` / ``ensemble_step``, ``sim/ensemble.py``, ``sim/service.py``):
device operations (kernels, copies, fills) in the traced segment per step."""
from lbmbench.readers import device_ops_per_step as read  # noqa: F401
