"""Device time a pair inside the program's ``vfidkr/sepconv/kernels`` spans
(``models/sepconv.py``): SepConv's four kernel subnets, netVertical1/2 and
netHorizontal1/2 (51-channel heads at full resolution). A program without
the span reads None."""

LAYER = "sepconv kernel subnets"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/sepconv/kernels")
