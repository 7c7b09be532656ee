"""device_idle_share — the device: the share of the device-only traced
segment in which no operation ran on it."""
from lbmbench.readers import device_idle_share as read  # noqa: F401
