"""Device time a pair outside the model's forward: the driver's pad, unpad,
clamp, round and copies (``apps/interpolate_video``)."""

LAYER = "driver"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.trace import FORWARD, UNIT as PAIR
    whole, fwd = t.range_device_ms(PAIR), t.range_device_ms(FORWARD)
    return None if whole is None or fwd is None else whole - fwd
