"""Device time a pair inside the program's ``vfidkr/softsplat/metric`` spans
(``models/softsplat.py``): SoftSplat's importance metric Z of both
directions: the backward warp of the other frame (``ops.warp.backwarp``),
the mean absolute difference over RGB, times alpha, clipped. A program
without the span reads None."""

LAYER = "softsplat metric"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/softsplat/metric")
