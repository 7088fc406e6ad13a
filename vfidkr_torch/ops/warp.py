"""PWC-Net feature warp, NCHW.

Counterpart of ``pwc_warp`` in ``vfidkr_tpu/ops/warp.py`` (reference
``PWCNet/PWCNet.py:159-199``): ``grid_sample`` with a grid normalised
align-corners style (``2 * v / (W-1) - 1``) but sampled with
``align_corners=False`` and zero padding, times a validity mask that is the
grid-sampled ones thresholded at 0.9999.  Plain PyTorch: the JAX package has
no Pallas kernel here.
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
