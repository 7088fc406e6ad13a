"""AdaCoF's sampling, NCHW float32: the "adaptive collaboration of flows"
of "AdaCoF: Adaptive Collaboration of Flows for Video Frame
Interpolation" (Lee et al., CVPR 2020, arXiv:1907.10244; the operator
``FunctionAdaCoF`` of github.com/HyeongminLEE/AdaCoF-pytorch).

Each output pixel (y, x) of a frame is a weighted sum of F x F bilinear
samples, each at its own learned offset from a dilated grid point.  With
P the frame replication-padded by pad = D (F - 1) / 2 (Hp x Wp), tap n =
i F + j (0 <= i, j < F) of pixel (y, x) samples P at

    u = y + i D + alpha[n](y, x),   v = x + j D + beta[n](y, x)

(alpha the vertical offset, beta the horizontal).  The offset is split
at its floor, A = floor(alpha), a = alpha - A (and B, b of beta); the four
corners are rows y + i D + A and that + 1, columns x + j D + B and that +
1, each clamped to the padded frame, blended bilinearly by a and b:

    T(y, x) = sum_n W[n](y, x) ((1 - a)((1 - b) P[u0, v0] + b P[u0, v1])
                                + a ((1 - b) P[u1, v0] + b P[u1, v1]))

which is the paper's bilinear sample at the position clamped to the padded
frame (a clamped corner and a clamped position give the same value); the
fraction comes from the offset alone, so it keeps float32's precision far
from the frame's origin.  ``adacof_pair`` gives AdaCoF's output frame,
``V T_0 + (1 - V) T_2``, both frames' sums blended by the occlusion map V.

On CUDA tensors ``adacof_pair`` launches the kernel K14 ``adacof``
(``vfidkr_torch/csrc/adacof.cu``): both frames and the blend in one
launch, the replication pad never materialised (the frame read with
clamped coordinates), each block's box of the frame staged in shared
memory, true float32 on the CUDA cores, no atomics (two launches give the
same bits); three channels only.  On CPU tensors it runs
``adacof_pair_plain``.  K14 has no backward: a CUDA input that needs a
gradient raises.  It replaces no TPU kernel: the JAX package has no
AdaCoF.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels

K14_CHANNELS = 3


def _check_pair(i0, w0, a0, b0, i2, w2, a2, b2, occ, dilation) -> int:
    """Raise unless the shapes, devices and dtypes fit; returns F."""
    if i0.dim() != 4 or i0.numel() == 0 or tuple(i2.shape) != tuple(i0.shape):
        raise ValueError(f"i0 and i2 must be one non-empty (N,C,H,W) shape, "
                         f"got {tuple(i0.shape)} and {tuple(i2.shape)}")
    n, _, h, w = i0.shape
    taps = w0.shape[1] if w0.dim() == 4 else 0
    f = math.isqrt(taps)
    if f * f != taps or f % 2 == 0:
        raise ValueError(f"the maps need F x F channels, F odd, got {taps}")
    for name, m in (("w0", w0), ("a0", a0), ("b0", b0), ("w2", w2),
                    ("a2", a2), ("b2", b2)):
        if tuple(m.shape) != (n, taps, h, w):
            raise ValueError(f"{name} must be (N, F*F, H, W) = "
                             f"{(n, taps, h, w)}, got {tuple(m.shape)}")
    if tuple(occ.shape) != (n, 1, h, w):
        raise ValueError(f"occ must be {(n, 1, h, w)}, got "
                         f"{tuple(occ.shape)}")
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"dilation must be a positive int, got {dilation!r}")
    tensors = (i0, w0, a0, b0, i2, w2, a2, b2, occ)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("adacof_pair: tensors on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("adacof_pair: float32 tensors only")
    return f


def adacof_plain(frame: torch.Tensor, weight: torch.Tensor,
                 alpha: torch.Tensor, beta: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """Plain PyTorch version of one frame's sum T (module docstring):
    frame (N,C,H,W), weight, alpha, beta (N,F*F,H,W) -> (N,C,H,W), a tap at
    a time, its four corners gathered from the padded frame."""
    n, c, h, w = frame.shape
    taps = weight.shape[1]
    f = math.isqrt(taps)
    pad = dilation * (f - 1) // 2
    hp, wp = h + 2 * pad, w + 2 * pad
    flat = F.pad(frame, (pad, pad, pad, pad), mode="replicate").reshape(
        n, c, hp * wp)
    ys = torch.arange(h, device=frame.device).view(1, h, 1)
    xs = torch.arange(w, device=frame.device).view(1, 1, w)

    def corner(r, col):
        idx = (r.clamp(0, hp - 1) * wp + col.clamp(0, wp - 1)).view(
            n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).view(n, c, h, w)

    out = frame.new_zeros(n, c, h, w)
    for t in range(taps):
        i, j = divmod(t, f)
        fa, fb = torch.floor(alpha[:, t]), torch.floor(beta[:, t])
        ta, tb = (alpha[:, t] - fa)[:, None], (beta[:, t] - fb)[:, None]
        r0 = ys + i * dilation + fa.long()
        c0 = xs + j * dilation + fb.long()
        top = corner(r0, c0) * (1 - tb) + corner(r0, c0 + 1) * tb
        bottom = corner(r0 + 1, c0) * (1 - tb) + corner(r0 + 1, c0 + 1) * tb
        out = out + weight[:, t:t + 1] * (top * (1 - ta) + bottom * ta)
    return out


def adacof_pair_plain(i0, w0, a0, b0, i2, w2, a2, b2, occ,
                      dilation: int) -> torch.Tensor:
    """Plain PyTorch version: ``occ T_0 + (1 - occ) T_2``, each T by
    ``adacof_plain``."""
    return (occ * adacof_plain(i0, w0, a0, b0, dilation)
            + (1 - occ) * adacof_plain(i2, w2, a2, b2, dilation))


def _launch(i0, w0, a0, b0, i2, w2, a2, b2, occ, f, dilation):
    n, c, h, w = i0.shape
    if c != K14_CHANNELS:
        raise ValueError(f"adacof: K14 takes {K14_CHANNELS} channels, got "
                         f"{c}")
    kernels.check_inputs("adacof", i0, w0, a0, b0, i2, w2, a2, b2, occ)
    out = torch.empty_like(i0)
    kernels.launch("adacof", i0, w0, a0, b0, i2, w2, a2, b2, occ, out, n, h,
                   w, f, dilation)
    return out


def adacof_pair(i0: torch.Tensor, w0: torch.Tensor, a0: torch.Tensor,
                b0: torch.Tensor, i2: torch.Tensor, w2: torch.Tensor,
                a2: torch.Tensor, b2: torch.Tensor, occ: torch.Tensor,
                dilation: int) -> torch.Tensor:
    """Frames i0, i2 (N,C,H,W), each frame's weights, vertical and
    horizontal offsets (N,F*F,H,W), F odd, and the occlusion map occ
    (N,1,H,W) -> (N,C,H,W): ``occ T_0 + (1 - occ) T_2`` (module
    docstring).  K14 on CUDA tensors, the plain version on CPU tensors."""
    f = _check_pair(i0, w0, a0, b0, i2, w2, a2, b2, occ, dilation)
    tensors = (i0, w0, a0, b0, i2, w2, a2, b2, occ)
    if i0.device.type == "cpu":
        return adacof_pair_plain(*tensors, dilation)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("adacof: K14 has no backward; the CUDA path is "
                           "evaluation only")
    return _launch(*tensors, f, dilation)
