"""Inputs that reach the branches of K7 (``filter_interpolate_ctx``), K3
(``flow_project_finalize``), K2 (``flow_project_scatter``) and K1
(``filter_interpolate_fwd``), made with numpy from a seed, NCHW float32.

K7 stages the 4x4 windows of an 8x32 output tile in shared memory, and takes
its direct gather for a tile whose windows spread over too many cells; K3
searches filled bitmasks, 32 cells a word, and reads on past its 32x32 tile
where a hole has no filled cell inside it.  K2 sums an 8x32 tile of source
pixels in a shared-memory box of the cells they land on, and adds straight
to the sums where that box is too large, and flushes the box by 16-byte adds
where W % 4 == 0; K1 reads its flow and filter before the validity test and
its taps clamped at the frame's edge.  The CPU tests hold the plain versions
to the JAX package on these inputs, and the card-only tests hold the kernels
to the plain versions on them.
"""
import numpy as np


def _bilinear(coarse: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N,C,a,b) -> (N,C,h,w), align_corners=True."""
    a, b = coarse.shape[-2:]
    ys = np.linspace(0.0, a - 1.0, h)
    xs = np.linspace(0.0, b - 1.0, w)
    y0 = np.minimum(np.floor(ys).astype(int), a - 2)
    x0 = np.minimum(np.floor(xs).astype(int), b - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    c00 = coarse[..., y0[:, None], x0[None, :]]
    c01 = coarse[..., y0[:, None], x0[None, :] + 1]
    c10 = coarse[..., y0[:, None] + 1, x0[None, :]]
    c11 = coarse[..., y0[:, None] + 1, x0[None, :] + 1]
    return ((1 - fy) * ((1 - fx) * c00 + fx * c01)
            + fy * ((1 - fx) * c10 + fx * c11))


def smooth_flow(rng, n, h, w, amp, base=(0.0, 0.0)) -> np.ndarray:
    """``base`` plus a smooth random flow up to +-``amp`` px."""
    coarse = (rng.rand(n, 2, 3, 5) * 2 - 1) * amp
    flow = _bilinear(coarse, h, w) + np.asarray(base).reshape(1, 2, 1, 1)
    return np.ascontiguousarray(flow, np.float32)


def discontinuous_flow(rng, n, h, w) -> np.ndarray:
    """(+30, +20) px on one side of the line x + 2y = 0.6 (W + 2H) and
    (-30, -20) on the other, plus a smooth +-2 px: the windows of a tile
    that the line crosses spread over some 60 x 40 cells, past K7's
    staging box."""
    side = np.where(np.arange(w)[None, :] + 2 * np.arange(h)[:, None]
                    < 0.6 * (w + 2 * h), 1.0, -1.0)
    jump = side[None, None] * np.array([30.0, 20.0]).reshape(1, 2, 1, 1)
    return np.ascontiguousarray(smooth_flow(rng, n, h, w, 2.0) + jump,
                                np.float32)


def k7_inputs(rng, n, c, h, w, flow):
    """The image (N,C,H,W) and filter (N,16,H,W) beside ``flow``."""
    image = rng.rand(n, c, h, w).astype(np.float32)
    filt = rng.randn(n, 16, h, w).astype(np.float32)
    return image, flow, filt


def word_crossing_sums(rng, n, h, w) -> np.ndarray:
    """(N,3,H,W) scatter sums with counts 1-3 and holes in runs that cross
    32- and 64-cell word boundaries along rows and along columns, runs that
    reach the frame's edge, a whole empty row and column, and a block of
    holes over a 32x32 tile's corner; the sums are 0 at the holes, as the
    scatter leaves them.  Needs H >= 48 and W >= 112."""
    acc = (rng.randn(n, 3, h, w) * 8).astype(np.float32)
    cnt = rng.randint(1, 4, (n, h, w)).astype(np.float32)
    cnt[:, 5, 20:100] = 0.0                   # row: across 32, 64 and 96
    cnt[:, 40:44, 60:w - 4] = 0.0
    cnt[:, h // 3, 0:w - 10] = 0.0            # row, from the left edge
    cnt[:, h // 3 + 1, w // 2:] = 0.0         # row, to the right edge
    cnt[:, 10:h - 5, 7] = 0.0                 # column: across 32 and 64
    cnt[:, h // 2:, 33] = 0.0                 # column, to the bottom edge
    cnt[:, 0:h - 8, 2 * w // 3:2 * w // 3 + 3] = 0.0
    cnt[:, 28:h - 10, 70:110] = 0.0           # a block over a tile corner
    cnt[:, h - 2, :] = 0.0                    # a whole row
    cnt[:, :, w - 3] = 0.0                    # a whole column
    acc[:, 2] = cnt
    acc[:, :2] *= (cnt > 0)[:, None]
    return acc


def edge_band_flow(n, h, w, shift=24.0) -> np.ndarray:
    """A uniform move of ``shift`` px to the right: its projection leaves
    the columns left of ``shift`` empty over the whole height."""
    flow = np.zeros((n, 2, h, w), np.float32)
    flow[:, 0] = shift
    return flow


def converging_flow(n, h, w, k=0.4) -> np.ndarray:
    """Every pixel moves toward the top-left corner by ``k`` of its
    distance from it: the frame folds into its top-left (1 - k)^2 part, and
    each cell there takes the adds of several source pixels, neighbouring
    lanes of a warp landing in one cell.  fx, fy <= 0, so a cell's flow sums
    keep one sign."""
    pos = np.stack(np.broadcast_arrays(np.arange(w)[None, :],
                                       np.arange(h)[:, None]))
    flow = np.broadcast_to(-k * pos[None], (n, 2, h, w))
    return np.ascontiguousarray(flow, np.float32)


def scatter_jump_flow(rng, n, h, w) -> np.ndarray:
    """(+44, +28) px on the top-left side of the line x + 2y = (W + 2H) / 4
    and (+3, +2) on the other, plus a smooth +-1: the targets of an 8x32
    tile that the line crosses spread over some 80 x 37 cells, past K2's
    shared-memory box.  Both sides move right and down, so a cell's flow
    sums keep one sign."""
    near = (np.arange(w)[None, :] + 2 * np.arange(h)[:, None]
            < (w + 2 * h) / 4)
    jump = np.where(near[None, None], np.array([44.0, 28.0]).reshape(1, 2, 1, 1),
                    np.array([3.0, 2.0]).reshape(1, 2, 1, 1))
    return np.ascontiguousarray(smooth_flow(rng, n, h, w, 1.0) + jump,
                                np.float32)


def border_landing_flow(rng, n, h, w) -> np.ndarray:
    """A smooth move of 0-1 px right and down, but the last 12 columns land
    exactly on x2 == W-1 and the last 10 rows exactly on y2 == H-1 (their
    two right or bottom targets are one cell, which takes two adds; the
    corner four)."""
    flow = rng.rand(n, 2, h, w).astype(np.float32)
    flow[:, 0, :, w - 12:] = (w - 1) - np.arange(w - 12, w, dtype=np.float32)
    flow[:, 1, h - 10:, :] = ((h - 1) - np.arange(h - 10, h, dtype=np.float32)
                              )[:, None]
    return flow


def depth_weight(rng, n, h, w) -> np.ndarray:
    """An inverse depth 1e-6 + exp(-U(-1, 3)), in (0.0498, 2.7183]: the
    depth-weighted projection's weight."""
    return (1e-6 + np.exp(-rng.uniform(-1, 3, (n, h, w)))).astype(np.float32)


def warp_edge_flow(rng, n, h, w) -> np.ndarray:
    """A smooth +-6 px flow with the warp's bounds met exactly on whole rows
    of the first image: (W/2, 0) and (0, H/2) (invalid by |f| where the
    landing is in the frame: the pixel is copied), (W/2 - 0.5, 0) and
    (0, H/2 - 0.5) (valid), x2 == W-1 and y2 == H-1 (valid, inclusive)."""
    flow = smooth_flow(rng, n, h, w, 6.0)
    rows = {2: (w / 2, 0.0), 3: (w / 2 - 0.5, 0.0), 4: (0.0, h / 2),
            5: (0.0, h / 2 - 0.5), h - 7: (0.0, 6.0)}
    for y, f in rows.items():
        flow[0, :, y, :] = np.asarray(f, np.float32)[:, None]
    flow[0, 0, 6, :] = (w - 1) - np.arange(w, dtype=np.float32)
    flow[0, 1, 6, :] = 0.0
    return flow
