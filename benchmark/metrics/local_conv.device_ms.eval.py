"""Device time a pair inside the program's ``vfidkr/sepconv/local_conv`` spans
(``models/sepconv.py``): SepConv's separable local convolution of both
frames (K9 ``sepconv_pair``, ``ops/separable_conv.py``). A program without
the span reads None."""

LAYER = "local conv"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/sepconv/local_conv")
