"""PWC-Net's flow heads in float32: ``conv2d(x, w, b)``, 3x3, stride 1,
padding 1, from a level's C channels to 2: the five ``predict_flow{lvl}`` of
``vfidkr_torch/models/pwcnet.py`` (C = 529, 661, 629, 597, 565 at levels 6
to 2), each reading its level's dense buffer.

On CUDA tensors ``flow_head`` launches the kernel K11 ``flow_head``
(``vfidkr_torch/csrc/flow_head.cu``: a bytes-bound reduction over the input
channels on the CUDA cores in true float32, each buffer value read from
device memory once, the channels split over a thread-block cluster where the
frame is small, a fixed summation order, no scratch buffer); on CPU tensors
it runs ``flow_head_plain``, bit for bit the ``predict_flow{lvl}`` module's
output.  The JAX package's heads are plain XLA convs
(``vfidkr_tpu/models/pwcnet.py``): K11 replaces no TPU kernel, it takes the
place of cuDNN's float32 conv and bias add.

Under autograd the kernel runs inside ``_FlowHead``, whose backward is the
node autograd runs for the plain version: ``convolution_backward`` on the
saved input and weight.

``plan`` picks K11's tile (8 or 16 rows x 32 columns) and the number of
blocks that split a tile's input channels from the shape alone (N, H, W, C)
and the card's SM count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels

CO = 2            # output channels
KSIZE = 3
PAD = 1
TILE_W = 32       # output columns of a K11 block
SMALL, LARGE = 8, 16  # output rows of K11's two tiles
STAGE_C = 8       # input channels a stage of its ring
MAX_SPLIT = 16    # the largest cluster (Hopper's, not portable)
FILL = 2          # blocks an SM that the plan aims for

_PLANS: dict = {}  # (n, h, w, c, sms) -> (rows, split)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N,C,H,W), got "
                         f"{tuple(x.shape)}")
    want = (CO, x.shape[1], KSIZE, KSIZE)
    if tuple(w.shape) != want:
        raise ValueError(f"w must be {want} (a 3x3 kernel from the input's "
                         f"channels to {CO}), got {tuple(w.shape)}")
    if tuple(b.shape) != (CO,):
        raise ValueError(f"b must be ({CO},), got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"flow_head: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flow_head: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError("flow_head: tensors on different devices")


def flow_head_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``predict_flow{lvl}``'s conv."""
    return F.conv2d(x, w, b, padding=PAD)


def plan(n: int, h: int, w: int, c: int, sms: int) -> tuple:
    """(tile rows, split) of K11 for the shape.  The large tile where the
    map has more than 8 rows and its tiles, split up to 16 ways, make
    ``FILL`` blocks an SM; else the small tile.  Then the least split (a
    power of two, at most 16 and at most the stages of 8 input channels)
    that makes ``FILL`` blocks an SM, or the largest.  (Fitted to K11's
    device times on an H100 at the 20 levels of cells 1, 2, 3 and 5, each
    tile and splits 1 to 16: the choices sum to 3.1 % over the best ones,
    and are the best at every level of cells 1 and 4.)"""
    key = (n, h, w, c, sms)
    if key not in _PLANS:
        cap = min(MAX_SPLIT, math.ceil(c / STAGE_C))
        cols = math.ceil(w / TILE_W)
        want = FILL * sms
        rows = SMALL
        if h > SMALL and n * math.ceil(h / LARGE) * cols * MAX_SPLIT >= want:
            rows = LARGE
        tiles = n * math.ceil(h / rows) * cols
        split = 1
        while split * 2 <= cap and tiles * split < want:
            split *= 2
        _PLANS[key] = (rows, split)
    return _PLANS[key]


def _launch(x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    n, c, h, wd = x.shape
    out = torch.empty((n, CO, h, wd), dtype=x.dtype, device=x.device)
    rows, split = plan(n, h, wd, c, kernels.sm_count(x.device))
    kernels.launch("flow_head", x, w, b, out, n, c, h, wd, rows, split)
    return out


class _FlowHead(torch.autograd.Function):
    """K11 under autograd; the gradient of its conv and bias
    (``convolution_backward`` on the saved input and weight)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return torch.ops.aten.convolution_backward(
            g, x, w, [CO], [1, 1], [PAD, PAD], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad))


def flow_head(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """(N,C,H,W) -> (N,2,H,W) float32, ``conv2d(x, w, b, padding=1)`` for
    ``w`` (2,C,3,3) and ``b`` (2,): K11 on CUDA tensors (under autograd
    too), the plain version on CPU tensors."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return flow_head_plain(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _FlowHead.apply(x, w, b)
    return _launch(x, w, b)
