"""Device time a pair of the kernel U-Net and its two heads
(``models/mononet.py``)."""

LAYER = "kernel U-Net"
UNIT = "ms/pair"
MOVES = "frames_per_s"
RANGES = {name: (name, name) for name in (
    "initScaleNets_filter", "initScaleNets_filter1", "initScaleNets_filter2")}


def read(t):
    return t.range_device_ms(*(f"bench/{n}" for n in RANGES))
