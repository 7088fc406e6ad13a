"""The rectifier's residual trunk in the bf16 eval lane.

Counterpart of ``fused_resblocks`` in
``vfidkr_tpu/ops/pallas/rectify_kernel.py:135`` (the fused branch of
``MultipleBasicBlock``, ``vfidkr_tpu/models/resblock.py:60-85``): three
bias-free residual blocks of 3x3 128 -> 128 convolutions,

    t = relu(conv(h, w[2k]));  h = relu(conv(t, w[2k+1]) + h)   (k = 0, 1, 2)

with bf16 operands, float32 sums, the residual added in the float32
accumulator before ReLU, and each conv's output rounded to bf16.  (The
chained bf16 lane of ``ResBasicBlock`` adds the residual after the bf16
cast instead; this is the TPU kernel's semantics, which its bf16 lane runs.)

On CUDA tensors ``fused_resblocks`` launches the kernel ``fused_resblocks``
(``vfidkr_torch/csrc/fused_resblocks.cu``) six times, once per conv; on CPU
tensors it runs ``fused_resblocks_plain``.  It takes any N, H and W: the
TPU kernel's VMEM gate (``fused_resblocks_ok``) has no counterpart here.  It
is forward only: on a CUDA tensor that needs a gradient it raises.

The kernel reads and writes the activations channels-last (NHWC, the TPU
kernel's own layout: a pixel's 128 channels are one 256-byte row), so on
CUDA the wrapper converts its input to ``torch.channels_last`` once (a no-op
when it already is) and returns a channels-last tensor; the public shape
stays (N,128,H,W).  It packs the six convs' weights once a call
(``pack_trunk_weights``) into the layout the kernel's weight ring reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels

C = 128          # the trunk's width
N_CONVS = 6      # conv1, conv2 of blocks 2, 3, 4


def _check_shapes(x, w6):
    if x.dim() != 4 or x.shape[1] != C or x.numel() == 0:
        raise ValueError(f"x must be (N,{C},H,W), got {tuple(x.shape)}")
    if tuple(w6.shape) != (N_CONVS, C, C, 3, 3):
        raise ValueError(f"w6 must be {(N_CONVS, C, C, 3, 3)}, got "
                         f"{tuple(w6.shape)}")


def pack_trunk_weights(w6: torch.Tensor) -> torch.Tensor:
    """(6,128,128,3,3) (out, in, kh, kw) -> (6,9,128,128), contiguous, of
    the same dtype: ``packed[k, dy * 3 + dx, co, ci] = w6[k, co, ci, dy,
    dx]``.  Each conv's taps as [tap][out][in], so a 64-input-channel slice
    of one tap is 128 rows of 128 bf16 bytes, the K-major B tile that the
    kernel's weight ring loads."""
    return w6.permute(0, 3, 4, 1, 2).reshape(N_CONVS, 9, C, C).contiguous()


def fused_resblocks_plain(x: torch.Tensor, w6: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each conv is ``F.conv2d`` in float32 on the
    bf16-rounded operands, which is bf16 operands with float32 sums (a
    product of two bf16 values is exact in float32).  It takes either memory
    format and computes in NCHW, so both give the same bits; the result is
    NCHW-contiguous."""
    _check_shapes(x, w6)
    w = w6.to(torch.bfloat16).float()
    h = x.contiguous().to(torch.bfloat16).float()
    for k in range(N_CONVS // 2):
        t = F.relu(F.conv2d(h, w[2 * k], padding=1)).to(torch.bfloat16).float()
        h = F.relu(F.conv2d(t, w[2 * k + 1], padding=1) + h).to(
            torch.bfloat16).float()
    return h.to(torch.bfloat16)


def fused_resblocks(x: torch.Tensor, w6: torch.Tensor) -> torch.Tensor:
    """(N,128,H,W) bf16 -> (N,128,H,W) bf16 through the three residual
    blocks whose six conv weights ``w6`` (6,128,128,3,3) bf16 stacks in
    conv1/conv2 order of blocks 2, 3, 4 (PyTorch's (out, in, kh, kw)).
    On CUDA the result is channels-last."""
    _check_shapes(x, w6)
    if x.device.type == "cpu":
        return fused_resblocks_plain(x, w6)
    if torch.is_grad_enabled() and (x.requires_grad or w6.requires_grad):
        raise RuntimeError("fused_resblocks has no backward: the bf16 lane is "
                           "evaluation only (run under torch.no_grad)")
    x = x.contiguous(memory_format=torch.channels_last)
    taps = pack_trunk_weights(w6)
    kernels.check_inputs("fused_resblocks", x, dtype=torch.bfloat16,
                         memory_format=torch.channels_last)
    kernels.check_inputs("fused_resblocks", taps, dtype=torch.bfloat16)
    if taps.device != x.device:
        raise ValueError("fused_resblocks: tensors on different devices")
    n, _, h, w = x.shape
    t = torch.empty_like(x)
    out = torch.empty_like(x)
    h_in = x
    for k in range(N_CONVS // 2):
        kernels.launch("fused_resblocks", h_in, taps[2 * k], None, t, n, h, w)
        # in place: a tile's residual is read before the tile is written
        kernels.launch("fused_resblocks", t, taps[2 * k + 1], h_in, out,
                       n, h, w)
        h_in = out
    return out
