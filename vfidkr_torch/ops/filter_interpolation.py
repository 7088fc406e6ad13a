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
"""

from __future__ import annotations

import torch

from vfidkr_torch import kernels
from vfidkr_torch.parallel.spatial import no_grad_in_frame, row_frame

FILTER_SIZE = 4
MAX_NARROW_C = 8       # widest tensor that filter_interpolate_fwd takes


def _check_shapes(image, flow, filt):
    if image.dim() != 4:
        raise ValueError(f"image must be (N,C,H,W), got {tuple(image.shape)}")
    n, _, h, w = image.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"flow must be {(n, 2, h, w)}, got {tuple(flow.shape)}")
    fs2 = FILTER_SIZE * FILTER_SIZE
    if tuple(filt.shape) != (n, fs2, h, w):
        raise ValueError(f"filt must be {(n, fs2, h, w)}, got {tuple(filt.shape)}")
    if image.numel() == 0:
        raise ValueError("empty image")


def filter_interpolate_plain(image: torch.Tensor, flow: torch.Tensor,
                             filt: torch.Tensor, row0: int = 0,
                             hg: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: 16 clamped tap gathers, weighted and summed in
    tap order.  ``row0, hg``: the block's place in a row-sharded frame
    (default: the whole frame)."""
    _check_shapes(image, flow, filt)
    n, c, h, w = image.shape
    hg = h if hg is None else hg
    fx, fy = flow[:, 0], flow[:, 1]
    xx = torch.arange(w, dtype=torch.float32, device=image.device)
    yy = torch.arange(h, dtype=torch.float32, device=image.device).view(h, 1)
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
    alpha = x2s - x0
    beta = y2s - y0
    ix = x0.long()
    iy = y0.long() - row0

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
