"""Device time a pair inside the program's ``vfidkr/softsplat/pyramid`` spans
(``models/softsplat.py``): SoftSplat's feature pyramid of both frames
(``extractor``: six 3x3 convs and their PReLUs). A program without the span
reads None."""

LAYER = "softsplat pyramid"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/softsplat/pyramid")
