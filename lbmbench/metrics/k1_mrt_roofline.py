"""k1_mrt_roofline — K1's LBMRT quasi-compressible instantiation
(``csrc/stream_collide.cu``, ``stream_collide_kernel<T, Q, MODE, MRT,
QUASI, FORCE>`` with MRT and QUASI true: the 19x19 collision matrix in
shared memory): the Eqn-10 bytes of one launch's node updates over the mean
device time of those records, as a share of the bandwidth peak, in percent,
on ``readers.kernel_roofline``'s terms.  Bytes bound this instantiation,
not its ~1,015 flops a node.  None unless the segment's records of it
number the launches ``stream_collide_tiles`` counted there (an LBGK record,
a lost or a stray one reads nothing), and unless every ``lbm.run`` span of
the segment names ``collision="lbmrt"`` and ``fluid="quasi_compressible"``:
the spans say which physics each launch under them ran."""
import dataclasses
import re

from lbmbench.readers import kernel_roofline

# the profiler's record name, as the card gives it:
# "void repro::stream_collide_kernel<double, 19, 0, true, true, false>(...)"
RECORD = re.compile(r"stream_collide_kernel<\w+, \d+, \d+, true, true, \w+>")
KERNELS = ("stream_collide_kernel",)
COUNTER = "stream_collide_tiles"
PHYSICS = {"collision": "lbmrt", "fluid": "quasi_compressible"}


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    runs = [s.attrs for s in trace.spans if s.name == "lbm.run"]
    if not runs or any(a.get(k) != v for a in runs for k, v in PHYSICS.items()):
        return None
    ops = [op for op in trace.ops if RECORD.search(op[2])]
    return kernel_roofline(dict(ctx, trace=dataclasses.replace(trace, ops=ops)), KERNELS, COUNTER)
