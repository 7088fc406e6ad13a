"""The work of PWC-Net's dense-block convs, K10 ``dense_conv``
(``vfidkr_torch/csrc/dense_conv.cu``), from the cell's shapes.

A bidirectional decode runs PWC-Net's five levels on a batch of 2B (both
directions); level l (2 to 6) sees the padded frame at 1/2^l, and its dense
block is five 3x3 convs of ``Cin -> Cout``, Cin growing by each output
(``od + 128, + 128, + 96, + 64``).  A conv is ``2 * 9 * Cin * Cout``
operations a pixel; its bytes are its input and output planes and its
weights and bias, read or written once, float32.  A conv's bound is the
larger of its operations at the float32 peak and its bytes at the memory's
rate (``work.PEAK_FLOPS``, ``work.HBM_BYTES_S``); a decode's is the sum of
its 25.  The counts follow the plain semantics, so they read the same
whatever implements them.
"""

from __future__ import annotations

import sys

from benchmark.lib.work import F32, HBM_BYTES_S, PEAK_FLOPS

KERNEL = "dense_conv_kernel"        # K10's name in a device trace
DENSE = (128, 128, 96, 64, 32)      # the dense block's outputs, in order
NCORR = 81                          # the cost volume's channels
# a level's decoder input: cost volume, own features, upsampled flow and
# feature of the coarser level
OD = {6: NCORR, 5: NCORR + 128 + 4, 4: NCORR + 96 + 4, 3: NCORR + 64 + 4,
      2: NCORR + 32 + 4}
LAUNCHES = 5 * len(OD)              # a decode's dense convs


def convs(n: int, h: int, w: int) -> list:
    """(n, cin, cout, h, w) of each of a decode's 25 dense convs, for a
    batch of ``n`` frames of ``h`` x ``w`` (multiples of 64)."""
    out = []
    for lvl, od in OD.items():
        cin = od
        for cout in DENSE:
            out.append((n, cin, cout, h >> lvl, w >> lvl))
            cin += cout
    return out


def conv_work(n: int, cin: int, cout: int, h: int, w: int) -> tuple:
    """(bytes, operations) of one dense conv."""
    px = n * h * w
    return (F32 * (px * (cin + cout) + cout * (9 * cin + 1)),
            2 * 9 * cin * cout * px)


def bound_s(n: int, h: int, w: int) -> float:
    """The least time a decode's 25 dense convs could take on the card."""
    return sum(max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS["float32"])
               for nbytes, ops in (conv_work(*c) for c in convs(n, h, w)))


def cell_decode(cell: dict) -> tuple:
    """(n, h, w) of PWC-Net's decode in the eval cell ``cell``
    (``cell.resolve``): both directions of the traffic's batch, on its
    frames after the driver's padding (``evalcell.reference_pad``'s rule: up
    to the next multiple of 128, or 32 a side where the side is one)."""
    from benchmark.lib.evalcell import MIN_PAD, PAD_MULTIPLE

    def padded(side):
        more = PAD_MULTIPLE - side % PAD_MULTIPLE
        return side + (more if side % PAD_MULTIPLE else 2 * MIN_PAD)
    mix = cell["mix"]
    return 2 * mix["batch"], padded(mix["height"]), padded(mix["width"])


def running_cell(argv=None) -> str | None:
    """The cell this process runs: ``benchmark/run.py``'s ``--workload``,
    read from its command line (None where there is none)."""
    argv = sys.argv[1:] if argv is None else argv
    for i, arg in enumerate(argv):
        if arg == "--workload" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--workload="):
            return arg.split("=", 1)[1]
    return None
