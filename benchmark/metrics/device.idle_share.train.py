"""As ``device.idle_share.eval``, over the traced steps' window."""

LAYER = "device"
UNIT = "%"
MOVES = "train_step_ms"


def read(t):
    idle = t.idle_share()
    return None if idle is None else 100.0 * idle
