"""The work of SoftSplat's splat, K12 ``softmax_splat``
(``vfidkr_torch/csrc/softmax_splat.cu``), from the cell's shapes.

A pair splats three levels, both directions of each in one launch: level k
(1 to 3) holds the padded frame at 1/2^(k-1) with ``channels[k - 1]``
channels (35: the frame and the pyramid's first 32, then 64 and 96).  A
source pixel reads its C values, its flow (2) and its importance (1) once,
and its cell's C outputs are written once, float32; it adds (C + 1) values
(the weight sum last) at four corners, a multiply-add each.  A launch's
bound is the larger of its bytes at the memory's rate and its operations at
the float32 peak (``work.HBM_BYTES_S``, ``work.PEAK_FLOPS``); a pair's is
the sum of its levels'.  The counts follow the plain semantics, so they
read the same whatever implements them.
"""

from __future__ import annotations

from benchmark.lib.work import F32, HBM_BYTES_S, PEAK_FLOPS

KERNEL = "softmax_splat"            # K12's kernels' names in a device trace
CORNERS = 4


def splat_work(n: int, c: int, h: int, w: int) -> tuple:
    """(bytes, operations) of one launch over (n, c, h, w) sources."""
    px = n * h * w
    return F32 * px * (2 * c + 3), 2 * CORNERS * (c + 1) * px


def bound_s(n: int, c: int, h: int, w: int) -> float:
    """The least time one launch could take on the card."""
    nbytes, ops = splat_work(n, c, h, w)
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS["float32"])


def levels(n: int, h: int, w: int, channels) -> list:
    """(n, c, h, w) of each level's launch: a batch of ``n`` sources (both
    directions), level k at 1/2^(k-1) of ``h`` x ``w``."""
    return [(n, c, h >> k, w >> k) for k, c in enumerate(channels)]


def pair_bound_s(n: int, h: int, w: int, channels) -> float:
    """The least time a pair's launches could take on the card."""
    return sum(bound_s(*lvl) for lvl in levels(n, h, w, channels))


def cell_pair(cell: dict) -> tuple:
    """(n, h, w, channels) of a pair's splat in the eval cell ``cell``
    (``cell.resolve``): both directions of the traffic's batch on its
    frames after the driver's padding (``flow_dense.cell_decode``, PWC-Net's
    batch on the same frames), and the configuration's
    ``splat_channels``."""
    from benchmark.lib.flow_dense import cell_decode
    return (*cell_decode(cell), tuple(cell["config"]["splat_channels"]))
