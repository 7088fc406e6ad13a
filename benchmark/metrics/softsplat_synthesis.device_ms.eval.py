"""Device time a pair inside the program's ``vfidkr/softsplat/synthesis`` spans
(``models/softsplat.py``): SoftSplat's GridNet (``synthesis``: 3 rows x 6
columns of 3x3 convs, PReLUs and bilinear upsamples) to the frame. A program
without the span reads None."""

LAYER = "softsplat synthesis"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/softsplat/synthesis")
