"""Device idle time a pair of the traced window while the main thread is
inside the program's ``vfidkr/forward`` span: the model's own host work
(launches, Python) keeps the card waiting."""

LAYER = "entry"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.spans import FORWARD, idle_ms
    return idle_ms(t, FORWARD, inside=True)
