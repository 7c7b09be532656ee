"""service_self_ms_per_session — the service (``sim/service.py``): host
milliseconds inside ``sim.service.step`` spans that no ``sim.group.step``
span covers (admission, seats, finishes, bookkeeping), per session the
annotated traced run finished."""
from lbmbench.readers import span_self_ms_per_finish


def read(ctx):
    return span_self_ms_per_finish(ctx, "sim.service.step", "sim.group.step")
