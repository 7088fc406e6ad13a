"""Device time a step of the loss: the program's ``vfidkr/train/loss`` span
(``training/loss.py`` after the model's call) and its backward,
``vfidkr/train/loss/backward``."""

LAYER = "loss + backward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import backward_ms
    return backward_ms(t, "vfidkr/train/loss/backward",
                       forward=("vfidkr/train/loss",))
