"""Device time a pair of the S2DF context net (``models/s2df.py``)."""

LAYER = "context"
UNIT = "ms/pair"
MOVES = "frames_per_s"
RANGES = {"ctxNet": ("ctxNet", "ctxNet")}


def read(t):
    return t.range_device_ms("bench/ctxNet")
