"""service_submit_ms_per_session — the service's entry
(``SimService.submit``): host milliseconds a client waits in ``submit``
per session it hands in during the measured window."""
from lbmbench.readers import submit_ms_per_session as read  # noqa: F401
