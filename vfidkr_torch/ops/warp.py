"""Backward warps, NCHW: counterpart of ``vfidkr_tpu/ops/warp.py``.

* ``pwc_warp``, PWC-Net's feature warp (reference
  ``PWCNet/PWCNet.py:159-199``): ``grid_sample`` with a grid normalised
  align-corners style (``2 * v / (W-1) - 1``) but sampled with
  ``align_corners=False`` and zero padding, times a validity mask that is
  the grid-sampled ones thresholded at 0.9999.
* ``interpolate_bilinear``, the legacy Interpolation and InterpolationCh
  ops (``my_package/Interpolation/interpolation_cuda_kernel.cu:27-99``,
  which no model calls): sample at ``(x + fx, y + fy)``, valid iff
  ``0 <= x2 < W`` and ``0 <= y2 < H`` (an exclusive upper bound, unlike the
  filter interpolation's), the taps clamped to the frame, 0 where invalid.
* ``backwarp``, Softmax Splatting's warp for its importance metric
  (``models/softsplat.py``): bilinear at exactly ``(x + fx, y + fy)``, each
  of the four taps 0 where it lies outside the frame.  ``pwc_warp``'s
  normalisation by ``W - 1`` under ``align_corners=False`` and its mask are
  PWC-Net's quirks, not this metric's.

All three are plain PyTorch on every device, not a fallback: the JAX package
has no Pallas kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pwc_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``x`` (N,C,H,W) by ``flow`` (N,2,H,W) (fx, fy)."""
    n, _, h, w = x.shape
    xx = torch.arange(w, dtype=torch.float32, device=x.device)
    yy = torch.arange(h, dtype=torch.float32, device=x.device).view(h, 1)
    gx = 2.0 * (xx + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (yy + flow[:, 1]) / max(h - 1, 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    ones = torch.ones((n, 1, h, w), dtype=x.dtype, device=x.device)
    mask = F.grid_sample(ones, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)
    return out * (mask >= 0.9999).to(x.dtype)


def interpolate_bilinear(image: torch.Tensor,
                         flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` (N,C,H,W) by ``flow`` (N,2,H,W) (fx, fy),
    JAX's ``interpolate_bilinear`` (``vfidkr_tpu/ops/warp.py:36-77``); 0
    where the landing leaves the frame.  Autograd gives the gradients of
    both inputs (a landing on the frame's edge takes the full flow gradient,
    where JAX's ``jnp.clip`` halves it)."""
    n, c, h, w = image.shape
    xx = torch.arange(w, dtype=torch.float32, device=image.device)
    yy = torch.arange(h, dtype=torch.float32, device=image.device).view(h, 1)
    x2 = xx + flow[:, 0]
    y2 = yy + flow[:, 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 < w) & (y2 < h)
    gx = x2.clamp(0, w - 1)
    gy = y2.clamp(0, h - 1)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    a = (gx - x0).unsqueeze(1)
    b = (gy - y0).unsqueeze(1)
    flat = image.reshape(n, c, h * w)

    def take(yi, xi):
        lin = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return torch.gather(flat, 2, lin).reshape(n, c, h, w)

    out = ((1 - a) * (1 - b) * take(y0, x0) + a * (1 - b) * take(y0, x1)
           + (1 - a) * b * take(y1, x0) + a * b * take(y1, x1))
    return torch.where(valid.unsqueeze(1), out, 0.0)


def backwarp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``x`` (N,C,H,W) by ``flow`` (N,2,H,W) (fx, fy):
    ``out[c, y, x]`` is the bilinear sample of ``x`` at ``(x + fx, y +
    fy)``, a tap outside the frame reading 0."""
    n, c, h, w = x.shape
    qx = torch.arange(w, dtype=x.dtype, device=x.device) + flow[:, 0]
    qy = torch.arange(h, dtype=x.dtype, device=x.device).view(h, 1) \
        + flow[:, 1]
    x0, y0 = torch.floor(qx), torch.floor(qy)
    ax, ay = (qx - x0).unsqueeze(1), (qy - y0).unsqueeze(1)
    flat = x.reshape(n, c, h * w)
    out = 0.0
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            lin = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            tap = torch.gather(flat, 2, lin.view(n, 1, h * w).expand(
                n, c, h * w)).view(n, c, h, w)
            out = out + torch.where(inside.unsqueeze(1), tap, 0.0) * (wx * wy)
    return out
