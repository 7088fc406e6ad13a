"""Device idle time a step of the traced window while the main thread is in
none of the program's ``vfidkr/forward``, ``vfidkr/train/loss``,
``vfidkr/train/backward`` and ``vfidkr/train/optimizer`` spans: the
trainer's turn between steps (the loss read back, the batch fetched and
copied, ``zero_grad``)."""

LAYER = "train loop"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import STEP, idle_ms
    return idle_ms(t, *STEP, inside=False)
