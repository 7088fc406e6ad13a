"""As ``kernels_roofline.eval``, in the traced steps."""

LAYER = "kernels"
UNIT = "%"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.harness import roofline_share
    return roofline_share(t)
