"""The least time of a pair's convolution FLOPs (the reference's, counted by
``FlopCounterMode`` at the cell's shapes), each at the published H100 peak
of the precision its module runs in, over the traced window's time a pair."""

LAYER = "entry"
UNIT = "%"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.harness import mfu
    return mfu(t)
