"""The work of SepConv's local convolution, K9 ``sepconv_pair``
(``vfidkr_torch/csrc/sepconv_pair.cu``), from its shapes: both frames of a
pair convolved at every pixel with their own separable kernel of ``taps`` x
``taps``, summed.

A pixel of one frame and one channel takes ``taps * taps + taps``
multiply-adds (each row of taps times the horizontal taps, then each row
sum times its vertical tap), two operations each.  Bytes: the two frames
and the four filter maps read once, the output written once, float32.  The
bound is the larger of the operations at the float32 peak and the bytes at
the memory's rate (``work.PEAK_FLOPS``, ``work.HBM_BYTES_S``).  The counts
follow the plain semantics, so they read the same whatever implements it.
"""

from __future__ import annotations

from benchmark.lib.work import F32, HBM_BYTES_S, PEAK_FLOPS

KERNEL = "sepconv_pair_kernel"      # K9's name in a device trace


def local_conv_work(n: int, c: int, h: int, w: int, taps: int) -> tuple:
    """(bytes, operations) of one launch over (n, c, h, w) frames."""
    px = n * h * w
    ops = 2 * 2 * c * px * (taps * taps + taps)
    nbytes = F32 * px * (2 * c + 4 * taps + c)
    return nbytes, ops


def cell_shape(cell: dict) -> tuple:
    """(n, c, h, w, taps) of K9's launches in the eval cell ``cell``
    (``cell.resolve``): the traffic's batch and frames after the driver's
    padding (``evalcell.reference_pad``'s rule: up to the next multiple of
    128, or 32 a side where the side is one), RGB, the configuration's
    ``filter_size`` taps."""
    from benchmark.lib.evalcell import MIN_PAD, PAD_MULTIPLE

    def padded(side):
        more = PAD_MULTIPLE - side % PAD_MULTIPLE
        return side + (more if side % PAD_MULTIPLE else 2 * MIN_PAD)
    mix = cell["mix"]
    return (mix["batch"], 3, padded(mix["height"]), padded(mix["width"]),
            cell["config"]["filter_size"])


def bound_s(n: int, c: int, h: int, w: int, taps: int) -> float:
    """The least time one launch could take on the card."""
    nbytes, ops = local_conv_work(n, c, h, w, taps)
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS["float32"])
