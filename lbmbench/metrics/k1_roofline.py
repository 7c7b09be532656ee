"""k1_roofline — K1 (``kernels/stream_collide.py`` -> ``csrc/stream_collide.cu``):
the Eqn-10 bytes of the node updates one launch does (every fluid node of
every replica it steps) over the launch's mean device time in the traced
segment and the card's bandwidth peak, in percent.  The bytes count fluid
nodes only, so the share sits below the kernel's achieved bandwidth by the
tiles' solid slots.  None where the segment's K1 records do not number the
launches that ``stream_collide_tiles.launches`` counted there."""
from lbmbench.readers import kernel_roofline

KERNELS = ("stream_collide_kernel",)
COUNTER = "stream_collide_tiles"


def read(ctx):
    return kernel_roofline(ctx, KERNELS, COUNTER)
