"""Device time a pair inside the program's ``vfidkr/adacof/sampling`` spans
(``models/adacof.py``): AdaCoF's sampling of both frames and their
occlusion blend (K14 ``adacof``, ``ops/adacof.py``). A program without the
span reads None."""

LAYER = "adacof sampling"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/adacof/sampling")
