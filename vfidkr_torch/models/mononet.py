"""MonoNet5 kernel-prediction U-Net and its branch heads, NCHW.

Counterpart of ``vfidkr_tpu/models/mononet.py:44-132`` (reference
``networks/DAIN.py:394-471``), chained evaluation only.  With
``compute_dtype=torch.bfloat16`` (the bf16 eval lane) every conv runs in
bf16 and the activations stay bf16: ReLU, max-pool, the bilinear x2
upsample and the skip adds; the caller casts the heads' outputs to
float32.  The children carry
the reference's flattened ``ModuleList`` indices (``0, 2, 5, ..., 32``), so
the parameter names are the reference checkpoint's keys.

The trunk is conv+ReLU (6->16), five conv+ReLU+maxpool stages
(->32->64->128->256->512), a mid conv+ReLU (512), then five stages of
bilinear x2 upsample, add the activation pushed before the matching maxpool,
conv+ReLU (->256->128->64->32->16).  Init: xavier uniform, zero bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vfidkr_torch.models.layers import conv, upsample_bilinear

# (reference ModuleList index, in channels, out channels) of each conv
_TRUNK = [(0, 6, 16), (2, 16, 32), (5, 32, 64), (8, 64, 128), (11, 128, 256),
          (14, 256, 512), (17, 512, 512), (20, 512, 256), (23, 256, 128),
          (26, 128, 64), (29, 64, 32), (32, 32, 16)]


class MonoNet5(nn.Module):
    """(B,6,H,W) with H, W divisible by 32 -> (B,16,H,W)."""

    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for idx, cin, cout in _TRUNK:
            self.add_module(str(idx), conv(cin, cout, generator=generator,
                                           compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [self._modules[str(idx)] for idx, _, _ in _TRUNK]
        h = F.relu(convs[0](x))
        skips = []
        for down in convs[1:6]:
            h = F.relu(down(h))
            skips.append(h)                   # pushed before the pool
            h = F.max_pool2d(h, 2)
        h = F.relu(convs[6](h))
        for up in convs[7:]:
            h = upsample_bilinear(h, 2) + skips.pop()
            h = F.relu(up(h))
        return h


class BranchHead(nn.Sequential):
    """conv(16,16) + ReLU + conv(16,16): the raw per-pixel 4x4 kernels
    (reference children ``0`` and ``2``)."""

    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        g, dt = generator, compute_dtype
        super().__init__(conv(16, 16, generator=g, compute_dtype=dt),
                         nn.ReLU(), conv(16, 16, generator=g, compute_dtype=dt))
