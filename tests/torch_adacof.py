"""K14 (``adacof``, AdaCoF's sampling of both frames and their occlusion
blend) at the shapes the cell runs it and at ragged ones, and its float64
yardstick, shared by the card-only tests and ``chip_smoke.py``."""
import torch

from vfidkr_torch.ops import adacof as AC

# (label, n, h, w, F, D, offsets): the cell's 1984 x 1152 at F = 11, D = 2
# with its tamed offsets (half the clip's move, a few px rms); ragged
# shapes no tile divides, with offsets past the staged box and the pad on
# every side; AdaCoF's F = 5, D = 1; F = 3 at D = 3
CASES = [
    ("cell", 1, 1152, 1984, 11, 2, "tamed"),
    ("ragged 37x75", 2, 37, 75, 11, 2, "far"),
    ("ragged 9x13 F=5", 1, 9, 13, 5, 1, "far"),
    ("40x70 F=3 D=3", 2, 40, 70, 3, 3, "tamed"),
]
# each value against the plain version in float64, its error over the
# float64 sum of its terms' magnitudes (the weights, the bilinear weights
# and the frames are all non-negative, so that sum is the float64 value
# itself): float32 corner weights and F^2 x 4 sums a frame in another order
# read about 1e-7; a dropped corner or a misplaced tap reads 1e-2 or more
TOL = 1e-5


def inputs(dev, n, h, w, f, kind, seed):
    """(i0, w0, a0, b0, i2, w2, a2, b2, occ) drawn on ``dev`` from
    ``seed``: frames and V uniform in [0, 1), each frame's weights a
    softmax over its F^2 taps; ``kind`` "tamed" offsets normal, 2 px rms
    about (2.5, -4) px for frame 0 and (-2.5, 4) for frame 2, "far" offsets
    uniform within 40 px, the first row -0.25 and the last column 40."""
    g = torch.Generator(device=dev).manual_seed(seed)
    taps = f * f
    i0, i2 = torch.rand(2, n, 3, h, w, generator=g, device=dev)
    w0, w2 = torch.softmax(
        torch.randn(2, n, taps, h, w, generator=g, device=dev) * 2, 2)
    if kind == "tamed":
        shift = torch.tensor([2.5, -4.0, -2.5, 4.0], device=dev).view(
            4, 1, 1, 1, 1)
        offs = torch.randn(4, n, taps, h, w, generator=g, device=dev) * 2
        offs = offs + shift
    else:
        reach = 40.0
        offs = (torch.rand(4, n, taps, h, w, generator=g, device=dev) * 2
                - 1) * reach
        offs[:, :, :, 0] = -0.25
        offs[:, :, :, :, -1] = reach
    occ = torch.rand(n, 1, h, w, generator=g, device=dev)
    a0, b0, a2, b2 = offs
    return i0, w0, a0, b0, i2, w2, a2, b2, occ


def errors(args, dilation, got) -> tuple:
    """(every value within TOL of its float64 value, the largest error over
    that value, max |kernel - float64|) of K14's ``got`` on ``args``."""
    want = AC.adacof_pair_plain(*(a.double() for a in args), dilation)
    err = (got.double() - want).abs()
    ok = bool((err <= TOL * want + 1e-12).all())
    return ok, float((err / (want + 1e-30)).max()), float(err.max())
