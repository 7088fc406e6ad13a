"""The work a cell asks of the card, from shapes: each hand-written
kernel launch's bytes and operations, the model's convolution FLOPs, and
the published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit).

A kernel launch's bound is the larger of its bytes (each input read once,
each output written once) at the memory's rate and its operations at the
peak of its precision.  The counts follow the kernels' plain semantics, so
they read the same work whatever implements it.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_S = 3.35e12
F32, BF16 = 4, 2
TAPS = 16           # the 4x4 filter
TRUNK_C = 128       # the rectifier trunk's width (K4)


def _nhw(n, h, w):
    return n * h * w


def kernel_work(name: str, args: tuple) -> tuple:
    """(bytes, operations, precision) of one launch of kernel ``name`` with
    the launch's arguments (tensors, ints and None, as the program passes
    them)."""
    if name in ("filter_interpolate_fwd", "filter_interpolate_ctx"):
        n, c, h, w = args[4:8]
        p = _nhw(n, h, w)
        # image and out of C channels, flow 2, filter 16
        return F32 * p * (2 * c + 2 + TAPS), 2 * TAPS * c * p, "float32"
    if name == "filter_interpolate_bwd":
        gimage = args[4]
        n, c, h, w = args[7:11]
        p = _nhw(n, h, w)
        read = c + 2 + TAPS + c                 # image, flow, filt, g
        write = 2 + TAPS + (c if gimage is not None else 0)
        return F32 * p * (read + write), 4 * TAPS * c * p, "float32"
    if name == "flow_project_scatter":
        weight = args[1]
        n, h, w = args[3:6]
        p = _nhw(n, h, w)
        # flow 2 (+ weight 1) in, sums 3 out; 3 values added at 4 cells
        return (F32 * p * (2 + (weight is not None) + 3), 12 * p,
                "float32")
    if name == "flow_project_finalize":
        n, h, w = args[2:5]
        p = _nhw(n, h, w)
        return F32 * p * (3 + 2), 2 * p, "float32"
    if name == "flow_project_scatter_bwd":
        n, h, w = args[3:6]
        p = _nhw(n, h, w)
        return F32 * p * (2 + 2 + 2), 8 * p, "float32"
    if name == "depth_flow_project_bwd":
        gdepth = args[6]
        n, h, w = args[7:10]
        p = _nhw(n, h, w)
        with_depth = gdepth is not None
        # flow 2, depth 1, g 2, cnt 1 in (+ out 2), gflow 2 out (+ gdepth 1)
        return (F32 * p * (8 + 3 * with_depth), (8 + 4 * with_depth) * p,
                "float32")
    if name == "fused_resblocks":
        res = args[2]
        n, h, w = args[4:7]
        p = _nhw(n, h, w)
        act = BF16 * p * TRUNK_C * (2 + (res is not None))
        return (act + BF16 * 9 * TRUNK_C * TRUNK_C,
                2 * p * TRUNK_C * TRUNK_C * 9, "bfloat16")
    raise KeyError(f"no work function for kernel {name!r}")


def bound_s(name: str, args: tuple) -> float:
    """The least time one launch could take on the card."""
    nbytes, ops, prec = kernel_work(name, args)
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[prec])


def launch_work(records: list) -> dict:
    """{kernel: [launches, bound seconds]} of ``kernels.record_launches``'
    records, which it then empties (they hold the launches' tensors)."""
    per: dict = {}
    for name, args in records:
        c = per.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += bound_s(name, args)
    records.clear()
    return per


def conv_flops_by_stage(fn, stage_hook_owner) -> dict:
    """``fn()`` under ``torch.utils.flop_counter.FlopCounterMode``, with the
    FLOPs (convolutions and matmuls) split by the reference's stages:
    {stage name (or "" outside any stage): flops}.  ``stage_hook_owner``
    is the reference module whose ``STAGE_HOOK`` reports each stage."""
    from torch.utils.flop_counter import FlopCounterMode

    counts: dict = {}
    counter = FlopCounterMode(display=False)

    def hook(name, call, args):
        before = counter.get_total_flops()
        out = call(*args)
        counts[name] = counts.get(name, 0) + counter.get_total_flops() - before
        return out

    stage_hook_owner.STAGE_HOOK = hook
    try:
        with counter:
            fn()
    finally:
        stage_hook_owner.STAGE_HOOK = None
    counts[""] = counter.get_total_flops() - sum(counts.values())
    return counts


def least_seconds(flops_by_stage: dict, lane: dict) -> float:
    """The least time the FLOPs could take at the peak of each stage's
    precision (outside the stages: float32)."""
    return sum(f / PEAK_FLOPS[lane.get(stage, "float32")]
               for stage, f in flops_by_stage.items())
