"""Device time a pair inside the program's ``vfidkr/flow/decoder`` spans:
each level's dense block, flow head, deconvs and joins
(``models/pwcnet.py``)."""

LAYER = "flow"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/flow/decoder")
