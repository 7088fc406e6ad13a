"""Adaptive ("deformable kernel region") filter interpolation, NCHW.

Counterpart of ``vfidkr_tpu/ops/filter_interpolation.py`` (the ``_ori``
forward of the reference CUDA op ``filterinterpolation_cuda_kernel.cu``).
Per output pixel ``(y, x)`` with flow ``(fx, fy)``:

* land at ``x2 = x + fx``, ``y2 = y + fy``;
* valid iff ``0 <= x2 <= W-1``, ``0 <= y2 <= H-1``, ``|fx| < W/2`` and
  ``|fy| < H/2``; an invalid pixel copies the source pixel;
* the 4x4 window starts at ``(floor(y2) - 1, floor(x2) - 1)``; each tap's
  read is clamped to the frame, its filter index ``dj * 4 + di`` is the
  unclamped window position;
* tap ``(dj, di)`` is weighted by ``filt[dj*4+di] * wy(dj) * wx(di)`` with
  ``wy = beta`` for ``dj >= 2`` else ``1 - beta`` (``beta = frac(y2)``), and
  likewise ``wx`` with ``alpha = frac(x2)``.

An invalid pixel's copy carries no gradient, as in the reference backward.
A landing on the frame's edge (``x2`` = 0 or W-1, ``y2`` = 0 or H-1) takes
the full flow gradient, as the reference's quadrant difference gives it;
the JAX package's ``jnp.clip`` halves it there.

On CUDA tensors ``filter_interpolate`` launches a forward kernel chosen by
the channel count, as the JAX package dispatches (``:682-688``):
``filter_interpolate_fwd`` (``vfidkr_torch/csrc/filter_interpolate.cu``,
a thread per pixel, its flow and 16 filter planes loaded at once) for
C <= 8, and ``filter_interpolate_ctx``
(``vfidkr_torch/csrc/filter_interpolate_ctx.cu``, a block per 8x32 tile
and range of channels, its windows staged in shared memory) for wider
tensors such as DAIN_slowmotion's 196-channel context.  Either is the forward of one autograd Function, whose backward is
the kernel ``filter_interpolate_bwd``
(``vfidkr_torch/csrc/filter_interpolate_bwd.cu``, generic in C).  On CPU
tensors it runs ``filter_interpolate_plain`` for any C, and autograd gives
its gradient.

Inside a row-sharded frame (``vfidkr_torch.parallel.spatial``) it runs on
one shard's halo-extended block, whose local row 0 is the frame's row
``row0``, and the row terms hold in the frame's coordinates, as JAX's
``_window_geometry`` has them (``vfidkr_tpu/ops/filter_interpolation.py:43-86``):
``y2 = (y + row0) + fy`` is the frame's row (rounded as the whole frame's,
see ``flow_projection._landing``), valid iff ``0 <= y2 <= hg-1`` and
``|fy| < hg/2`` (``hg`` the frame's height), ``y2`` clamped to the frame and
then to the block.  The tap
clamp is the block's: the halo replicates the frame's edge rows.  Both
kernels and the plain version take ``row0, hg``; nothing takes a gradient
inside a frame.

``filter_interpolate_deformable`` and
``filter_interpolate_nofilter_deformable`` are the reference's dormant deformable-tap variants (no model calls them).
They are plain PyTorch on every device, not a fallback: the JAX package
computes them with XLA gathers, and there is no TPU kernel to port.  They
share the landing and window above (``_window``) and raise inside a
row-sharded frame, which no driver opens around them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.parallel.spatial import (current_spatial_frame,
                                           no_grad_in_frame, row_frame)

FILTER_SIZE = 4
MAX_NARROW_C = 8       # widest tensor that filter_interpolate_fwd takes


def _check_shapes(image, flow, filt):
    if image.dim() != 4:
        raise ValueError(f"image must be (N,C,H,W), got {tuple(image.shape)}")
    n, _, h, w = image.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"flow must be {(n, 2, h, w)}, got {tuple(flow.shape)}")
    fs2 = FILTER_SIZE * FILTER_SIZE
    if filt is not None and tuple(filt.shape) != (n, fs2, h, w):
        raise ValueError(f"filt must be {(n, fs2, h, w)}, got {tuple(filt.shape)}")
    if image.numel() == 0:
        raise ValueError("empty image")


def _window(flow, h, w, row0=0, hg=None):
    """The landing and its window, shared by the plain and the deformable
    versions: (valid, x2, y2, ix, iy, alpha, beta), the window's top-left
    tap at ``(iy - 1, ix - 1)`` in the block's rows."""
    hg = h if hg is None else hg
    fx, fy = flow[:, 0], flow[:, 1]
    xx = torch.arange(w, dtype=torch.float32, device=flow.device)
    yy = torch.arange(h, dtype=torch.float32, device=flow.device).view(h, 1)
    x2 = xx + fx
    y2 = (yy + row0) + fy               # the frame's row (see _landing)
    valid = ((x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= hg - 1)
             & (fx.abs() < w / 2) & (fy.abs() < hg / 2))

    # clamped coordinates keep the masked-out invalid pixels in range; for
    # valid pixels the frame's clamp is the identity, and the block's binds
    # only for a flow that reaches past the block
    x2s = x2.clamp(0, w - 1)
    y2s = y2.clamp(0, hg - 1).clamp(row0, row0 + h - 1)
    x0 = torch.floor(x2s)
    y0 = torch.floor(y2s)
    return (valid, x2, y2, x0.long(), y0.long() - row0, x2s - x0,
            y2s - y0)


def filter_interpolate_plain(image: torch.Tensor, flow: torch.Tensor,
                             filt: torch.Tensor, row0: int = 0,
                             hg: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: 16 clamped tap gathers, weighted and summed in
    tap order.  ``row0, hg``: the block's place in a row-sharded frame
    (default: the whole frame)."""
    _check_shapes(image, flow, filt)
    n, c, h, w = image.shape
    valid, _, _, ix, iy, alpha, beta = _window(flow, h, w, row0, hg)

    flat = image.reshape(n, c, h * w)
    out = torch.zeros_like(image)
    for dj in range(FILTER_SIZE):
        wy = beta if dj >= 2 else 1.0 - beta
        ty = (iy - 1 + dj).clamp(0, h - 1)
        for di in range(FILTER_SIZE):
            wx = alpha if di >= 2 else 1.0 - alpha
            tx = (ix - 1 + di).clamp(0, w - 1)
            lin = (ty * w + tx).reshape(n, 1, h * w).expand(n, c, h * w)
            tap = torch.gather(flat, 2, lin).reshape(n, c, h, w)
            weight = filt[:, dj * FILTER_SIZE + di] * wy * wx
            out = out + weight.unsqueeze(1) * tap
    return torch.where(valid.unsqueeze(1), out, image.detach())


def forward_kernel(c: int) -> str:
    """The forward kernel that ``filter_interpolate`` launches at C = c."""
    return ("filter_interpolate_fwd" if c <= MAX_NARROW_C
            else "filter_interpolate_ctx")


def _launch_ctx(image, flow, filt, direct_tiles):
    out = torch.empty_like(image)
    kernels.launch("filter_interpolate_ctx", image, flow, filt, out,
                   *image.shape, *row_frame(image.shape[2]), direct_tiles)
    return out


def filter_interpolate_ctx_counted(image: torch.Tensor, flow: torch.Tensor,
                                   filt: torch.Tensor
                                   ) -> tuple[torch.Tensor, int]:
    """``filter_interpolate_ctx`` on CUDA tensors (C > 8), forward only,
    with the number of 8x32 tiles whose windows spread too far to stage in
    shared memory and took the kernel's direct gather instead."""
    _check_shapes(image, flow, filt)
    kernels.check_inputs("filter_interpolate_ctx", image, flow, filt)
    if image.shape[1] <= MAX_NARROW_C:
        raise ValueError("filter_interpolate_ctx takes C > "
                         f"{MAX_NARROW_C}, got {image.shape[1]}")
    count = torch.zeros(1, dtype=torch.int32, device=image.device)
    out = _launch_ctx(image, flow, filt, count)
    return out, int(count.item())


class _FilterInterpolateKernel(torch.autograd.Function):
    """Forward ``filter_interpolate_fwd`` (C <= 8) or
    ``filter_interpolate_ctx`` (C > 8), backward ``filter_interpolate_bwd``;
    the image scatter is skipped where the image needs no gradient."""

    @staticmethod
    def forward(ctx, image, flow, filt):
        n, c, h, w = image.shape
        name = forward_kernel(c)
        kernels.check_inputs(name, image, flow, filt)
        ctx.save_for_backward(image, flow, filt)
        if name == "filter_interpolate_ctx":
            return _launch_ctx(image, flow, filt, None)
        out = torch.empty_like(image)
        kernels.launch(name, image, flow, filt, out, n, c, h, w,
                       *row_frame(h))
        return out

    @staticmethod
    def backward(ctx, g):
        image, flow, filt = ctx.saved_tensors
        g = g.contiguous()
        kernels.check_inputs("filter_interpolate_bwd", g, image)
        need_image, need_flow, need_filt = ctx.needs_input_grad
        gimage = torch.zeros_like(image) if need_image else None
        gflow = torch.empty_like(flow)
        gfilt = torch.empty_like(filt)
        n, c, h, w = image.shape
        kernels.launch("filter_interpolate_bwd", image, flow, filt, g, gimage,
                       gflow, gfilt, n, c, h, w)
        return (gimage, gflow if need_flow else None,
                gfilt if need_filt else None)


def filter_interpolate(image: torch.Tensor, flow: torch.Tensor,
                       filt: torch.Tensor) -> torch.Tensor:
    """Warp ``image`` (N,C,H,W) by ``flow`` (N,2,H,W) with the per-pixel 4x4
    kernels ``filt`` (N,16,H,W).  Returns (N,C,H,W) float32."""
    _check_shapes(image, flow, filt)
    no_grad_in_frame("filter_interpolate", image, flow, filt)
    if image.device.type == "cpu":
        return filter_interpolate_plain(image, flow, filt,
                                        *row_frame(image.shape[2]))
    return _FilterInterpolateKernel.apply(image, flow, filt)


# ---------------------------------------------------------------------------
# the deformable-tap variants
# ---------------------------------------------------------------------------

QUADRANTS = ("static", "deformed")


def _check_offsets(image, offsets):
    n, _, h, w = image.shape
    want = (n, 2 * FILTER_SIZE * FILTER_SIZE, h, w)
    if tuple(offsets.shape) != want:
        raise ValueError(f"offsets must be {want}, got {tuple(offsets.shape)}")


def _deformable(image, flow, filt, offsets, quadrant):
    """The three deformable variants' shared math, JAX's
    ``_deformable_core`` (``vfidkr_tpu/ops/filter_interpolation.py:520-596``)
    on (N,C,H,W); ``filt`` None for the one without the filter."""
    if quadrant not in QUADRANTS:
        raise ValueError(f"quadrant must be one of {QUADRANTS}, got "
                         f"{quadrant!r}")
    _check_offsets(image, offsets)
    n, c, h, w = image.shape
    fs = FILTER_SIZE
    if current_spatial_frame() is not None:
        raise RuntimeError("the deformable filter interpolation is not "
                           "row-sharded: call it outside a spatial frame")
    valid, x2, y2, ix, iy, alpha, beta = _window(flow, h, w)

    # each tap's deformed position: the clamped tap plus its offset, the
    # first 16 offset channels Y and the next 16 X, both (N, dj, di, H, W)
    taps = torch.arange(fs, device=image.device).view(1, fs, 1, 1)
    tap_y = (iy.unsqueeze(1) - 1 + taps).clamp(0, h - 1).unsqueeze(2)
    tap_x = (ix.unsqueeze(1) - 1 + taps).clamp(0, w - 1).unsqueeze(1)
    off = offsets.reshape(n, 2, fs, fs, h, w)
    frac_y = tap_y.float() + off[:, 0]
    frac_x = tap_x.float() + off[:, 1]

    # C's int() truncates toward zero; the corners carry no gradient and
    # are read clamped to the frame (the reference reads them unclamped)
    top = torch.trunc(frac_y).detach()
    left = torch.trunc(frac_x).detach()
    phi_y = (frac_y - top).unsqueeze(1)
    phi_x = (frac_x - left).unsqueeze(1)
    ys = top.long().clamp(-1, h - 1) + 1
    xs = left.long().clamp(-1, w - 1) + 1
    pad = F.pad(image, (1, 1, 1, 1), mode="replicate")
    flat = pad.reshape(n, c, -1)

    def corner(dy, dx):
        lin = ((ys + dy) * (w + 2) + xs + dx).reshape(n, 1, -1)
        return torch.gather(flat, 2, lin.expand(n, c, lin.shape[2])
                            ).reshape(n, c, fs, fs, h, w)

    bi = ((1 - phi_x) * (1 - phi_y) * corner(0, 0)
          + phi_x * (1 - phi_y) * corner(0, 1)
          + (1 - phi_x) * phi_y * corner(1, 0)
          + phi_x * phi_y * corner(1, 1))
    if filt is not None:
        bi = bi * filt.reshape(n, 1, fs, fs, h, w)

    a = alpha.view(n, 1, 1, h, w)
    b = beta.view(n, 1, 1, h, w)
    if quadrant == "static":
        # by tap position, as the _ori op's separable weights
        wx = torch.where(taps.view(1, 1, fs, 1, 1) >= fs // 2, a, 1 - a)
        wy = torch.where(taps.view(1, fs, 1, 1, 1) >= fs // 2, b, 1 - b)
        qw = wy * wx
    else:
        # by the deformed position against the landing point
        qx = torch.where(frac_x <= x2.view(n, 1, 1, h, w), 1 - a, a)
        qy = torch.where(frac_y <= y2.view(n, 1, 1, h, w), 1 - b, b)
        qw = qx * qy
    out = (qw.unsqueeze(1) * bi).sum((2, 3))
    return torch.where(valid.unsqueeze(1), out, image.detach())


def filter_interpolate_deformable(image: torch.Tensor, flow: torch.Tensor,
                                  filt: torch.Tensor, offsets: torch.Tensor,
                                  quadrant: str = "static") -> torch.Tensor:
    """The reference's compiled but dormant deformable-tap variants of the
    filter interpolation, JAX's ``filter_interpolate_deformable``
    (``vfidkr_tpu/ops/filter_interpolation.py:599-634``).

    image (N,C,H,W), flow (N,2,H,W), filt (N,16,H,W), offsets (N,32,H,W):
    the first 16 channels each tap's Y offset and the next 16 its X offset
    (``filterinterpolation_cuda_kernel.cu:100-101``).  Each 4x4 tap reads a
    bilinear sample at its clamped tap position plus its offset; the corners
    are ``trunc`` of that position (toward zero), read clamped to the frame;
    the filter index is the unclamped tap.  ``quadrant="static"``
    (``FilterInterpolationLayer_gpu_forward``, :29-255) weights each tap by
    its tap position, as the ``_ori`` op; ``"deformed"``
    (``_kernelfunc_deforconv``, :1353-1498) by its deformed position against
    the landing point (``frac_x <= x2``, ``frac_y <= y2``).  An invalid pixel
    copies the image, with no gradient; autograd gives the gradients of the
    image, flow, filter and offsets.  A landing on the frame's edge takes the
    full flow gradient, as ``filter_interpolate``'s does.

    Plain PyTorch on every device: the JAX package computes it with XLA
    gathers, not a Pallas kernel, so it has no CUDA kernel here."""
    _check_shapes(image, flow, filt)
    return _deformable(image, flow, filt, offsets, quadrant)


def filter_interpolate_nofilter_deformable(image: torch.Tensor,
                                           flow: torch.Tensor,
                                           offsets: torch.Tensor
                                           ) -> torch.Tensor:
    """``..._kernelfunc_nofilterwithdeforconv``
    (``filterinterpolation_cuda_kernel.cu:2070-2194``, JAX's
    ``filter_interpolate_nofilter_deformable``): the ``"deformed"``
    variant without the per-tap filter.  Plain PyTorch on every device, as
    ``filter_interpolate_deformable``."""
    _check_shapes(image, flow, None)
    return _deformable(image, flow, None, offsets, "deformed")
