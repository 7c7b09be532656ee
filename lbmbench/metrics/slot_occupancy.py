"""slot_occupancy — the service (``sim/service.py``): session steps the
measured window advanced over its slots times its service steps."""
from lbmbench.readers import slot_occupancy as read  # noqa: F401
