"""Device time a pair inside the program's ``vfidkr/softsplat/splat`` spans
(``models/softsplat.py``): SoftSplat's splat: the three levels' resizes of
the flow and Z, K12 ``softmax_splat`` (``ops/softsplat.py``) on both
directions a level, and the joins of the directions. A program without the
span reads None."""

LAYER = "softsplat splat"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/softsplat/splat")
