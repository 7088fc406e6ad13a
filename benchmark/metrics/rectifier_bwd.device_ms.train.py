"""Device time a step of the rectifier's backward (``models/resblock.py``):
the program's ``vfidkr/rectifier/backward`` spans, each with the gradient
sums of its node's evaluation."""

LAYER = "loss + backward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import backward_ms
    return backward_ms(t, "vfidkr/rectifier/backward")
