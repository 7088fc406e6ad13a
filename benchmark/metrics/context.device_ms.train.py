"""Device time a step of the frozen S2DF context net's forward inside the
train step (``models/s2df.py``, the 196-channel contexts with the detached
log-depth): the program's ``vfidkr/context`` spans.  It trains in no
group, so it has no backward."""

LAYER = "context"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import device_ms
    return device_ms(t, "vfidkr/context")
