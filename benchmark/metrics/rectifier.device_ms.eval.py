"""Device time a pair of the rectifier (``models/resblock.py``; in the bf16
lane its trunk is K4, ``ops/rectify.py``)."""

LAYER = "rectifier"
UNIT = "ms/pair"
MOVES = "frames_per_s"
RANGES = {"rectifyNet": ("rectifyNet", "rectifyNet")}


def read(t):
    return t.range_device_ms("bench/rectifyNet")
