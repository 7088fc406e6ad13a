"""Device time a step of the optimizer's step (Adamax over the three groups,
``training/train_state.py``)."""

LAYER = "optimizer"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.trace import OPT
    return t.range_device_ms(OPT)
