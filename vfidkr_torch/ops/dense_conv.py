"""PWC-Net's dense-block convs in float32: ``leaky_relu(conv2d(x, w, b),
0.1)``, 3x3, stride 1, padding 1, from Cin input channels to Cout (a
multiple of 32): the 25 ``conv{lvl}_{i}`` of ``vfidkr_torch/models/pwcnet.py``.

Two calls:

- ``dense_conv(x, w, b)`` returns a fresh (N, Cout, H, W) tensor and takes
  autograd (the training path, where ``_dense`` keeps its ``torch.cat``);
- ``dense_conv_into(buf, start, w, b)`` reads the channels ``start ..
  start + Cin - 1`` of the NCHW tensor ``buf`` and writes its output into the
  channels ``start - Cout .. start - 1``, in place and without autograd: the
  level's dense buffer, newest output first, with no join (the eval path).

On CUDA tensors both launch the kernel K10 ``dense_conv``
(``vfidkr_torch/csrc/dense_conv.cu``: an implicit GEMM on the CUDA cores in
true float32, bias and LeakyReLU in its epilogue, the input channels split
over a thread-block cluster where the frame is small, a fixed summation
order, no scratch buffer); on CPU tensors they run ``dense_conv_plain``,
bit for bit the ``conv{lvl}_{i}`` module's output.  The JAX package's dense
convs are plain XLA convs (``vfidkr_tpu/models/pwcnet.py:71-79``): K10
replaces no TPU kernel, it takes the place of cuDNN's float32 conv,
LeakyReLU and ``torch.cat``.

Under autograd the kernel runs inside ``_DenseConv`` followed by
``_LeakyReluOfOutput``, whose backwards are the two nodes autograd runs for
the plain version: the gradient scaled by 0.1 where the output is not
positive (``leaky_relu_backward`` on the saved output), then
``convolution_backward`` on the saved input and weight.

``plan`` picks K10's tile (8 or 16 rows x 32 columns x 32 channels) and the
number of blocks that split a tile's input channels from the shape alone
(N, H, W, Cin, Cout) and the card's SM count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels

SLOPE = 0.1
KSIZE = 3
PAD = 1
CO_TILE = 32      # output channels of a K10 block; Cout is a multiple of it
TILE_W = 32       # output columns of a K10 block
SMALL, LARGE = 8, 16  # output rows of K10's two tiles
LARGE_FROM = 4    # large-tile blocks an SM from which the large tile runs
STAGE_C = 8       # input channels a stage of its ring
MAX_SPLIT = 16    # the largest cluster (Hopper's, not portable)

_PLANS: dict = {}  # (n, h, w, cin, cout, sms) -> (rows, split)


def _check_params(w: torch.Tensor, b: torch.Tensor, dev: torch.device,
                  cin: int) -> None:
    if w.dim() != 4 or tuple(w.shape[2:]) != (KSIZE, KSIZE):
        raise ValueError(f"w must be (Cout, Cin, 3, 3), got {tuple(w.shape)}")
    cout = w.shape[0]
    if cout < CO_TILE or cout % CO_TILE:
        raise ValueError(f"Cout must be a positive multiple of {CO_TILE}, got "
                         f"{cout}")
    if w.shape[1] != cin:
        raise ValueError(f"w takes {w.shape[1]} input channels, the input has "
                         f"{cin}")
    if tuple(b.shape) != (cout,):
        raise ValueError(f"b must be ({cout},), got {tuple(b.shape)}")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"dense_conv: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dense_conv: {name} must be contiguous")
        if t.device != dev:
            raise ValueError("dense_conv: tensors on different devices")


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (N,C,H,W), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"dense_conv: {name} must be float32, got {x.dtype}")


def dense_conv_plain(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``conv{lvl}_{i}``'s conv and LeakyReLU."""
    return F.leaky_relu(F.conv2d(x, w, b, padding=PAD), SLOPE)


def plan(n: int, h: int, w: int, cin: int, cout: int,
         sms: int) -> tuple:
    """(tile rows, split) of K10 for the shape.  The large tile, unsplit,
    where it makes at least ``LARGE_FROM`` blocks an SM; else the small tile
    and the number of blocks (a cluster, a power of two) that split a
    tile's input channels minimising (blocks an SM, at least 2) x (stages a
    block, plus 1 for the ring's fill), the fewer on a tie.  (Fitted to
    K10's times on an H100 at 11 levels of cells 1 to 3, every split from 1
    to 16: the choices sum to 3.3 % over the best ones.)"""
    key = (n, h, w, cin, cout, sms)
    if key not in _PLANS:
        ctiles = cout // CO_TILE
        cols = math.ceil(w / TILE_W)
        if n * math.ceil(h / LARGE) * cols * ctiles >= LARGE_FROM * sms:
            _PLANS[key] = (LARGE, 1)
        else:
            base = n * math.ceil(h / SMALL) * cols * ctiles
            stages = math.ceil(cin / STAGE_C)
            cost = lambda s: (max(math.ceil(base * s / sms), 2)
                              * (math.ceil(stages / s) + 1))
            splits = [1 << k for k in range(MAX_SPLIT.bit_length())
                      if 1 << k <= min(MAX_SPLIT, stages)]
            _PLANS[key] = (SMALL, min(splits, key=cost))
    return _PLANS[key]


def _launch(x_ptr: int, xs: int, out_ptr: int, os: int, shape: tuple,
            w: torch.Tensor, b: torch.Tensor) -> None:
    """K10 from the input at ``x_ptr`` into the output at ``out_ptr``: (N,
    Cin, H, W) and (N, Cout, H, W) float32 on ``w``'s device, each with
    contiguous channel planes and the batch stride ``xs`` or ``os``,
    disjoint; ``shape`` is (N, Cin, H, W)."""
    n, cin, h, wd = shape
    cout = w.shape[0]
    rows, split = plan(n, h, wd, cin, cout, kernels.sm_count(w.device))
    kernels.launch("dense_conv", x_ptr, xs, w, b, out_ptr, os, n, cin, cout,
                   h, wd, rows, split)


def _fresh(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = x.new_empty((x.shape[0], w.shape[0], *x.shape[2:]))
    _launch(x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
            tuple(x.shape), w, b)
    return out


class _DenseConv(torch.autograd.Function):
    """K10 under autograd; the gradient of its conv and bias alone
    (``convolution_backward`` on the saved input and weight)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _fresh(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]], [1, 1], [PAD, PAD], [1, 1], False, [0, 0],
            1, list(ctx.needs_input_grad))


class _LeakyReluOfOutput(torch.autograd.Function):
    """The identity on K10's activated output, whose backward is the
    activation's gradient from that output (``leaky_relu_backward``): a node
    of its own, as autograd's LeakyReLU node is, so the output is released
    before the conv's gradient runs."""

    @staticmethod
    def forward(ctx, out):
        ctx.save_for_backward(out)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return torch.ops.aten.leaky_relu_backward(g, out, SLOPE, True)


def dense_conv(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """(N,Cin,H,W) -> (N,Cout,H,W) float32, ``leaky_relu(conv2d(x, w, b,
    padding=1), 0.1)`` for ``w`` (Cout,Cin,3,3) and ``b`` (Cout,): K10 on
    CUDA tensors (under autograd too), the plain version on CPU tensors."""
    _check_x(x, "x")
    _check_params(w, b, x.device, x.shape[1])
    if not x.is_contiguous():
        raise ValueError("dense_conv: x must be contiguous")
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _LeakyReluOfOutput.apply(_DenseConv.apply(x, w, b))
    return _fresh(x, w, b)


def dense_conv_into(buf: torch.Tensor, start: int, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """``buf[:, start - Cout:start] = dense_conv(buf[:, start:start + Cin],
    w, b)`` in place, for a contiguous (N,C,H,W) float32 ``buf``; no
    autograd.  K10 on CUDA tensors, the plain version on CPU tensors.
    Returns ``buf``."""
    _check_x(buf, "buf")
    if not buf.is_contiguous():
        raise ValueError("dense_conv_into: buf must be contiguous")
    cout, cin = w.shape[0], (w.shape[1] if w.dim() == 4 else 0)
    _check_params(w, b, buf.device, cin)
    if not cout <= start <= buf.shape[1] - cin:
        raise ValueError(f"dense_conv_into: channels {start - cout}..{start}"
                         f" and {start}..{start + cin} do not lie in the "
                         f"buffer's {buf.shape[1]}")
    if torch.is_grad_enabled() and (buf.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise ValueError("dense_conv_into writes in place and takes no "
                         "autograd: run it under torch.no_grad() or use "
                         "dense_conv")
    if buf.device.type == "cpu":
        buf[:, start - cout:start] = dense_conv_plain(
            buf[:, start:start + cin], w, b)
    else:
        # the two channel ranges as pointers into the buffer: no views made
        n, _, h, wd = buf.shape
        plane = h * wd * buf.element_size()
        _launch(buf.data_ptr() + start * plane, buf.stride(0),
                buf.data_ptr() + (start - cout) * plane, buf.stride(0),
                (n, cin, h, wd), w, b)
    return buf
