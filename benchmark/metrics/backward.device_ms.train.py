"""Device time a step from the forward's return to the optimizer's step:
the loss and the backward (``training/loss.py``, autograd, K5, K6)."""

LAYER = "loss + backward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.trace import FORWARD, OPT
    fwd, opt = t.ranges(FORWARD), t.ranges(OPT)
    if not fwd or len(fwd) != len(opt) or t.linked_share() < 0.9:
        return None
    spans = [(f_end, o_start) for (_, f_end), (o_start, _) in
             zip(sorted(fwd), sorted(opt))]
    return t.per_unit_ms(t.device_ns(t.launched_in(spans)))
