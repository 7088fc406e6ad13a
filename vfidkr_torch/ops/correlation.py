"""Cost-volume correlation for PWC-Net, NCHW.

Counterpart of ``vfidkr_tpu/ops/correlation.py`` (reference CUDA op
``correlation_cuda_kernel.cu``, kernel size 1).  Output channel
``(tj + md) * (2md + 1) + (ti + md)`` holds the channel mean of
``f1[:, :, y, x] * f2[:, :, y + tj, x + ti]``, with ``f2`` zero-padded by
``md``.  Plain PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
