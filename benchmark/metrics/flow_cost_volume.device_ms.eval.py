"""Device time a pair inside the program's ``vfidkr/flow/cost_volume``
spans: each level's feature warp (``ops/warp.pwc_warp``) and 81-channel
cost volume (``ops/correlation.py``)."""

LAYER = "flow"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/flow/cost_volume")
