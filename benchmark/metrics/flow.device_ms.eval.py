"""Device time a pair of PWC-Net (``models/pwcnet.py``, ``ops/correlation.py``,
``ops/warp.py``): launched from its first conv's call to its last one's
return."""

LAYER = "flow"
UNIT = "ms/pair"
MOVES = "frames_per_s"
RANGES = {"flownets": ("flownets.conv1a", "flownets.dc_conv7")}


def read(t):
    return t.range_device_ms("bench/flownets")
