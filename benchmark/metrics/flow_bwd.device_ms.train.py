"""Device time a step of PWC-Net's backward (``models/pwcnet.py``, the cost
volume's and the warp's gradients): the program's ``vfidkr/flow/backward``
spans, each with the gradient sums of its node's evaluation."""

LAYER = "loss + backward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import backward_ms
    return backward_ms(t, "vfidkr/flow/backward")
