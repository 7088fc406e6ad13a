"""As ``model.mfu.eval``, of a step's forward and backward FLOPs."""

LAYER = "entry"
UNIT = "%"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.harness import mfu
    return mfu(t)
