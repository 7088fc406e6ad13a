"""Device time a pair of the filter warp's kernels, K1
(``filter_interpolate_fwd``) and K7 (``filter_interpolate_ctx``), by kernel
name (``ops/filter_interpolation.py``)."""

LAYER = "filter warp"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    return t.named_device_ms("filter_interpolate_fwd_kernel",
                             "filter_interpolate_ctx_kernel")
