"""The rectifier's head in float32: ``relu(conv2d(x, w, b))``, 7x7, stride 1,
padding 3, from C input channels to 128 (``block1`` of
``MultipleBasicBlock``, ``vfidkr_torch/models/resblock.py``).

On CUDA tensors ``rectify_head`` launches the kernel K8 ``rectify_head``
(``vfidkr_torch/csrc/rectify_head.cu``: an implicit GEMM on the CUDA cores in
true float32, NCHW in and out, no scratch buffer, a fixed summation order); on
CPU tensors it runs ``rectify_head_plain``.  It takes any N, C, H and W.  The
JAX package's head is a plain XLA conv (``vfidkr_tpu/models/resblock.py:78``):
K8 replaces no TPU kernel, it takes the place of cuDNN's generic float32 conv
for this layer.

Under autograd the kernel runs inside ``_RectifyHead``, whose backward is the
one autograd runs for the plain version: the gradient masked where the output
is not positive (``threshold_backward``), then ``convolution_backward`` on
the saved input and weight.

``LAUNCHES`` counts K8's launches (a plain integer, raised under a lock: the
shards of a row-sharded forward launch from threads of their own).  K8 is
launched here and not through ``vfidkr_torch.kernels.launch``: it is not one
of ``kernels.KERNELS``.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from vfidkr_torch.kernels import build

CO = 128         # output channels
KSIZE = 7
PAD = 3

LAUNCHES = 0
_LOCK = threading.Lock()


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N,C,H,W), got "
                         f"{tuple(x.shape)}")
    want = (CO, x.shape[1], KSIZE, KSIZE)
    if tuple(w.shape) != want:
        raise ValueError(f"w must be {want} (a 7x7 kernel from the input's "
                         f"channels to {CO}), got {tuple(w.shape)}")
    if tuple(b.shape) != (CO,):
        raise ValueError(f"b must be ({CO},), got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"rectify_head: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rectify_head: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError("rectify_head: tensors on different devices")


def rectify_head_plain(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version."""
    return F.relu(F.conv2d(x, w, b, padding=PAD))


def _launch(x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    n, c, h, wd = x.shape
    out = torch.empty((n, CO, h, wd), dtype=x.dtype, device=x.device)
    fn = build.load_library().vfidkr_rectify_head
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n, c, h, wd, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rectify_head: CUDA launch failed with error {err}")
    with _LOCK:
        LAUNCHES += 1
    return out


class _RectifyHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        out = _launch(x, w, b)
        ctx.save_for_backward(x, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = torch.ops.aten.threshold_backward(g, out, 0)
        return torch.ops.aten.convolution_backward(
            g, x, w, [CO], [1, 1], [PAD, PAD], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad))


def rectify_head(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """(N,C,H,W) -> (N,128,H,W) float32, ``relu(conv2d(x, w, b,
    padding=3))`` for ``w`` (128,C,7,7) and ``b`` (128,): K8 on CUDA
    tensors, the plain version on CPU tensors."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return rectify_head_plain(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _RectifyHead.apply(x, w, b)
    return _launch(x, w, b)
