"""Device time a pair inside the program's ``vfidkr/flow/refine`` span:
PWC-Net's dilated context network and the final add
(``models/pwcnet.py``)."""

LAYER = "flow"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/flow/refine")
