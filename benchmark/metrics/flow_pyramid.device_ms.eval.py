"""Device time a pair inside the program's ``vfidkr/flow/pyramid`` spans:
PWC-Net's siamese conv pyramid over both frames, and the swapped batch
(``models/pwcnet.py``)."""

LAYER = "flow"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/flow/pyramid")
