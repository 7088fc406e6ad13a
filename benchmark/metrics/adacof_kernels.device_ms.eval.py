"""Device time a pair inside the program's ``vfidkr/adacof/kernels`` spans
(``models/adacof.py``): AdaCoF's seven heads, the weights' two (with their
softmax), the offsets' four (121-channel 3x3 convs at full size) and the
occlusion's. A program without the span reads None."""

LAYER = "adacof heads"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/adacof/kernels")
