"""Device idle time a pair of the traced window while the main thread is
outside the program's ``vfidkr/forward`` span: the driver's turn (to the
card, pad, unpad, round, the copy back, the caller's loop).  With
``forward.idle_ms.eval`` it makes up the window's idle time."""

LAYER = "driver"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import FORWARD, idle_ms
    return idle_ms(t, FORWARD, inside=False)
