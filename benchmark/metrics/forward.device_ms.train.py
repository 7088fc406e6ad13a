"""Device time a step of the model's forward under ``train_step``
(``models/dain.py``)."""

LAYER = "model forward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.trace import FORWARD
    return t.range_device_ms(FORWARD)
