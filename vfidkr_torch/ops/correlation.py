"""Cost-volume correlation for PWC-Net, NCHW.

Counterpart of ``vfidkr_tpu/ops/correlation.py`` (reference CUDA op
``correlation_cuda_kernel.cu``, kernel size 1).  Output channel
``(tj + md) * (2md + 1) + (ti + md)`` holds the channel mean of
``f1[:, :, y, x] * f2[:, :, y + tj, x + ti]``, with ``f2`` zero-padded by
``md``.  ``correlation_cost_volume`` is plain PyTorch: the JAX package has no
Pallas kernel here.

``cost_volume(f1, f2, 4)`` is PWC-Net's use of it (``PWCDCNet._corr``): the
volume at max displacement 4 through LeakyReLU(0.1).  On CUDA tensors it
launches the kernel K13 ``correlation`` (``vfidkr_torch/csrc/correlation.cu``:
each input read from device memory once a tile, the 81 sums of a pixel in
registers, the division by C and the LeakyReLU in its epilogue; the product
never exists in device memory); on CPU tensors it runs ``cost_volume_plain``,
bit for bit the chain of plain ops.  Under autograd the kernel runs inside
``_CostVolume``, whose backward launches K13's backward ``correlation_bwd``
(both gradients as gathers, no atomics); ``cost_volume_bwd_plain`` is its
plain version.  K13 runs one tile (4 x 32 pixels) at every level and batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels

MD = 4                    # the max displacement K13 takes
NCORR = (2 * MD + 1) ** 2
SLOPE = 0.1               # the LeakyReLU's


def correlation_cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                            max_displacement: int = 4) -> torch.Tensor:
    """(N,C,H,W) x (N,C,H,W) -> (N,(2md+1)**2,H,W)."""
    md = max_displacement
    n, c, h, w = f1.shape
    d = 2 * md + 1
    f2p = F.pad(f2, (md, md, md, md))
    # (N, C, d, d, H, W) view of every shifted window of f2p; no copy
    shifted = f2p.unfold(2, h, 1).unfold(3, w, 1)
    corr = (f1[:, :, None, None] * shifted).sum(1)
    return corr.reshape(n, d * d, h, w) / c


def cost_volume_plain(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: LeakyReLU(0.1) of the volume at max
    displacement 4."""
    return F.leaky_relu(correlation_cost_volume(f1, f2, MD), SLOPE)


def cost_volume_bwd_plain(f1: torch.Tensor, f2: torch.Tensor,
                          out: torch.Tensor, g: torch.Tensor) -> tuple:
    """Plain version of K13's backward: the gradients of ``f1`` and ``f2``
    given ``out = cost_volume(f1, f2)`` and its gradient ``g``, as two
    gathers.  With ``G = g * (out > 0 ? 1 : 0.1) / C`` and ``d = (dy, dx)``:
    ``grad_f1[c, p] = sum_d G[d, p] f2[c, p + d]`` and ``grad_f2[c, q] =
    sum_d G[d, q - d] f1[c, q - d]``, a term whose pixel leaves the frame
    dropped (zero padding)."""
    n, c, h, w = f1.shape
    k = 2 * MD + 1
    gd = torch.where(out > 0, g, g * SLOPE) / c
    gp = F.pad(gd, (MD, MD, MD, MD))
    f1p = F.pad(f1, (MD, MD, MD, MD))
    f2p = F.pad(f2, (MD, MD, MD, MD))
    gf1 = torch.zeros_like(f1)
    gf2 = torch.zeros_like(f2)
    for j in range(k):          # dy + MD
        for i in range(k):      # dx + MD
            d = j * k + i
            gf1 += gd[:, d:d + 1] * f2p[:, :, j:j + h, i:i + w]
            # q - d lies at padded offset (MD - dy, MD - dx)
            ys, xs = 2 * MD - j, 2 * MD - i
            gf2 += (gp[:, d:d + 1, ys:ys + h, xs:xs + w]
                    * f1p[:, :, ys:ys + h, xs:xs + w])
    return gf1, gf2


def _check(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int) -> None:
    if max_displacement != MD:
        raise ValueError(f"cost_volume: max displacement {MD} only, got "
                         f"{max_displacement}")
    if f1.dim() != 4 or f1.numel() == 0:
        raise ValueError(f"cost_volume: f1 must be a non-empty (N,C,H,W), "
                         f"got {tuple(f1.shape)}")
    if f2.shape != f1.shape:
        raise ValueError(f"cost_volume: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} differ")
    for name, t in (("f1", f1), ("f2", f2)):
        if t.dtype != torch.float32:
            raise TypeError(f"cost_volume: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cost_volume: {name} must be contiguous")
    if f2.device != f1.device:
        raise ValueError("cost_volume: f1 and f2 on different devices")


def _launch(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    n, c, h, w = f1.shape
    out = torch.empty((n, NCORR, h, w), dtype=f1.dtype, device=f1.device)
    kernels.launch("correlation", f1, f2, out, n, c, h, w)
    return out


def _launch_bwd(f1: torch.Tensor, f2: torch.Tensor, out: torch.Tensor,
                g: torch.Tensor, need1: bool, need2: bool) -> tuple:
    n, c, h, w = f1.shape
    gf1 = torch.empty_like(f1) if need1 else None
    gf2 = torch.empty_like(f2) if need2 else None
    kernels.launch("correlation_bwd", f1, f2, out, g, gf1, gf2, n, c, h, w)
    return gf1, gf2


class _CostVolume(torch.autograd.Function):
    """K13 under autograd; the backward is K13's, on the saved inputs and
    output."""

    @staticmethod
    def forward(ctx, f1, f2):
        out = _launch(f1, f2)
        ctx.save_for_backward(f1, f2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        f1, f2, out = ctx.saved_tensors
        return _launch_bwd(f1, f2, out, g.contiguous(),
                           *ctx.needs_input_grad)


def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = MD) -> torch.Tensor:
    """(N,C,H,W) x (N,C,H,W) -> (N,81,H,W) float32,
    ``leaky_relu(correlation_cost_volume(f1, f2, 4), 0.1)``: K13 on CUDA
    tensors (under autograd too), the plain version on CPU tensors."""
    _check(f1, f2, max_displacement)
    if f1.device.type == "cpu":
        return cost_volume_plain(f1, f2)
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return _CostVolume.apply(f1, f2)
    return _launch(f1, f2)
