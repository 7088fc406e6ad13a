"""Device time a step of the backward of the upsample, the flow projection
(K6) and the filter warp (K5): the program's
``vfidkr/{upsample,projection,filter_warp}/backward`` spans, each with the
gradient sums of its node's evaluation."""

LAYER = "loss + backward"
UNIT = "ms/step"
MOVES = "train_step_ms"


def read(t):
    from benchmark.lib.spans import backward_ms
    return backward_ms(t, "vfidkr/upsample/backward",
                       "vfidkr/projection/backward",
                       "vfidkr/filter_warp/backward")
