"""Host time a batch of the trainer's C++ augment (``data/native.py``,
``csrc/host/augment.cpp``) on the prefetch thread, over the batches it made
during the window: CPU work, so the host's clock."""

LAYER = "host augment"
UNIT = "ms/batch"
MOVES = "train_step_ms"


def read(t):
    s = t.extra.get("augment_s") or []
    return 1000.0 * sum(s) / len(s) if s else None
