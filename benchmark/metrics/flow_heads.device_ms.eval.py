"""Device time a pair inside the program's ``vfidkr/flow/heads`` spans:
PWC-Net's five flow heads, ``predict_flow{6..2}``'s conv and bias from each
level's dense buffer to 2 channels (``models/pwcnet.py``; K11,
``ops/flow_head.py``).  A program without the span reads None."""

LAYER = "flow"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/flow/heads")
