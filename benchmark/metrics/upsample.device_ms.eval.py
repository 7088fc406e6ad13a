"""Device time a pair inside the program's ``vfidkr/upsample`` spans: the
flows scaled by the time step, joined and upsampled x4
(``models/dain.py``, ``models/layers.upsample_bilinear``)."""

LAYER = "upsample + projection"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/upsample")
