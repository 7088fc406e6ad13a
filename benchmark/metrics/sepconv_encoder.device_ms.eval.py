"""Device time a pair inside the program's ``vfidkr/sepconv/encoder`` spans
(``models/sepconv.py``): SepConv's encoder, netConv1..5 and their 2x2 pools.
A program without the span reads None."""

LAYER = "sepconv encoder"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/sepconv/encoder")
