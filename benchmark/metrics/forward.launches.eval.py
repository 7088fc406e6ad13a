"""Device kernels a pair launched inside the program's ``vfidkr/forward``
span (``models/dain.py``): copies and sets left out."""

LAYER = "entry"
UNIT = "launches/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import FORWARD, kernels_launched
    return kernels_launched(t, FORWARD)
