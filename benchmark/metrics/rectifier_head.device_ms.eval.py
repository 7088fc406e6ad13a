"""Device time a pair inside the program's ``vfidkr/rectifier/head`` spans:
the rectifier's 7x7 head conv with its bias and ReLU (``models/resblock.py``;
in the float32 lane K8, ``ops/conv_head.py``; in the bf16 lane cuDNN's bf16
conv).  A program without the span reads None."""

LAYER = "rectifier"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/rectifier/head")
