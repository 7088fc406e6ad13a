"""Every hand-written kernel launch's bound (bytes at 3.35 TB/s or operations
at the peak, the larger) over their device time, in the traced pairs."""

LAYER = "kernels"
UNIT = "%"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.harness import roofline_share
    return roofline_share(t)
