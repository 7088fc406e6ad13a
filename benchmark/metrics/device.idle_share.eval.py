"""1 - (the union of the device's kernel, copy and set intervals) / (the
traced window, host clock, start to end)."""

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"


def read(t):
    idle = t.idle_share()
    return None if idle is None else 100.0 * idle
