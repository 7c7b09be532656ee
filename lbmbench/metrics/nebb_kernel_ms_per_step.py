"""nebb_kernel_ms_per_step — the NEBB pass's kernel (``kernels/nebb_pass.py``
-> ``csrc/nebb_pass.cu``, ``nebb_pass_kernel``): device milliseconds of its
launches in the device-only traced run, per traced step.  None where the
program launched no such kernel (a NEBB pass of aten ops, or none)."""
KERNEL = "nebb_pass_kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.steps:
        return None
    us = [end - start for start, end, name in trace.ops if KERNEL in name]
    if not us:
        return None
    return sum(us) / 1e3 / trace.steps
