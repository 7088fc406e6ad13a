"""Device time a step of the frozen MegaDepth hourglass's forward inside the
train step (``models/megadepth.py``): the program's ``vfidkr/depth`` spans.
It trains in no group, so it has no backward."""

LAYER = "depth"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/depth")
