"""The work of AdaCoF's sampling, K14 ``adacof``
(``vfidkr_torch/csrc/adacof.cu``), from the cell's shapes: both frames of a
pair sampled at every pixel at F x F learned offsets, each frame's samples
weighted and summed, the two sums blended by the occlusion map V.

Bytes, float32, each read or written once: a pixel's F^2 weights and F^2
vertical and horizontal offsets a frame, the frame's C values a frame, V
once a pair, and the output's C values.  Operations: a tap's four corners
times their weights, a multiply-add each, for C channels and both frames,
and the blend (a multiply-add a channel).  The bound is the larger of the
bytes at the memory's rate and the operations at the float32 peak
(``work.HBM_BYTES_S``, ``work.PEAK_FLOPS``).  The counts follow the plain
semantics, so they read the same whatever implements them.
"""

from __future__ import annotations

from benchmark.lib.work import F32, HBM_BYTES_S, PEAK_FLOPS

KERNEL = "adacof_kernel"            # K14's name in a device trace
CORNERS = 4
FRAMES = 2


def sampling_work(n: int, c: int, h: int, w: int, taps: int) -> tuple:
    """(bytes, operations) of one launch over (n, c, h, w) frame pairs with
    ``taps`` (F^2) samples a pixel a frame."""
    px = n * h * w
    nbytes = F32 * px * (FRAMES * (3 * taps + c) + 1 + c)
    ops = 2 * px * c * (FRAMES * CORNERS * taps + 2)
    return nbytes, ops


def bound_s(n: int, c: int, h: int, w: int, taps: int) -> float:
    """The least time one launch could take on the card."""
    nbytes, ops = sampling_work(n, c, h, w, taps)
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS["float32"])


def cell_shape(cell: dict) -> tuple:
    """(n, c, h, w, taps) of K14's launch in the eval cell ``cell``
    (``cell.resolve``): the traffic's batch on its frames after the
    driver's padding (``flow_dense.cell_decode``'s rule), RGB, the
    configuration's ``kernel_size`` squared."""
    from benchmark.lib.flow_dense import cell_decode
    n2, h, w = cell_decode(cell)
    return n2 // 2, 3, h, w, cell["config"]["kernel_size"] ** 2
