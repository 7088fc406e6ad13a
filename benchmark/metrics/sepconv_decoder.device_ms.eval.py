"""Device time a pair inside the program's ``vfidkr/sepconv/decoder`` spans
(``models/sepconv.py``): SepConv's decoder, netDeconv5..2, netUpsample5..2
and the skip adds. A program without the span reads None."""

LAYER = "sepconv decoder"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/sepconv/decoder")
