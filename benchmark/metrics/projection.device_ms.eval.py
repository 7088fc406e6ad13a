"""Device time a pair of the flow projection's kernels, K2
(``flow_project_scatter``) and K3 (``flow_project_finalize``), by kernel
name (``ops/flow_projection.py``)."""

LAYER = "upsample + projection"
UNIT = "ms/pair"
MOVES = "frames_per_s"


def read(t):
    return t.named_device_ms("flow_project_scatter_kernel",
                             "flow_project_finalize_kernel")
