"""Device time a pair inside the program's ``vfidkr/adacof/encoder`` and
``vfidkr/adacof/decoder`` spans (``models/adacof.py`` through the shared
``models/unet.py``): AdaCoF's U-Net, the input's mean subtracted,
moduleConv1..5 and their pools, moduleDeconv5..2, moduleUpsample5..2 and
the skip adds. A program without the spans reads None."""

LAYER = "adacof U-Net"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/adacof/encoder", "vfidkr/adacof/decoder")
