"""Device time a pair of the MegaDepth hourglass (``models/megadepth.py``)."""

LAYER = "depth"
UNIT = "ms/pair"
MOVES = "frames_per_s"
RANGES = {"depthNet": ("depthNet", "depthNet")}


def read(t):
    return t.range_device_ms("bench/depthNet")
