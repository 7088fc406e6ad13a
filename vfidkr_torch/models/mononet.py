"""MonoNet5 kernel-prediction U-Net and its branch heads, and the vestigial
OccNet and DeconvField, NCHW.

Counterpart of ``vfidkr_tpu/models/mononet.py:44-176`` (reference
``networks/DAIN.py:394-527``), chained evaluation only.  With
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

OccNet and DeconvField are built by the reference's DAIN and never called
(``DAIN.py:44-50``); their weights are in every reference DAIN checkpoint,
so ``DAIN(init_unused=True)`` builds them for strict loads.  Their children
carry the reference's flattened indices too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vfidkr_torch.models.layers import (
    avg_pool_2x2, conv, upsample_bilinear, upsample_bilinear_align_corners)

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


# OccNet's convs: (reference index, in channels, out channels), in the
# order of ``vfidkr_tpu/convert/torch_loader.py:132-138``'s _OCCNET_IDX
_OCC = [(0, 6, 32), (2, 32, 32), (5, 32, 64), (7, 64, 64), (10, 64, 128),
        (12, 128, 128), (15, 128, 256), (17, 256, 256), (20, 256, 512),
        (22, 512, 512), (25, 512, 512), (27, 512, 512),
        (30, 512, 512), (32, 512, 256), (34, 256, 256),
        (37, 256, 256), (39, 256, 128), (41, 128, 128),
        (44, 128, 128), (46, 128, 64), (48, 64, 64),
        (51, 64, 64), (54, 64, 1)]


class OccNet(nn.Module):
    """The reference's occlusion U-Net (``DAIN.py:474-501``, forward at
    :358-391; JAX's ``OccNet``, ``mononet.py:140-163``): (B,6,H,W) with H,
    W divisible by 32 -> (B,1,H,W) in (0, 1).  Six blocks of two conv+ReLU
    (->32, then after each 2x2 average pool ->64->128->256->512->512), the
    outputs of blocks 2-5 kept; four stages of align-corners x2 upsample,
    conv+ReLU and the kept output added, the first three followed by a
    block (->256->128->64); a last upsample, conv (->1) and sigmoid."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        for idx, cin, cout in _OCC:
            self.add_module(str(idx), conv(cin, cout, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = iter(self._modules[str(idx)] for idx, _, _ in _OCC)

        def block(h):
            h = F.relu(next(convs)(h))
            return F.relu(next(convs)(h))

        h = block(x)
        skips = []
        for _ in range(4):
            h = block(avg_pool_2x2(h))
            skips.append(h)
        h = block(avg_pool_2x2(h))
        for stage in range(4):
            h = F.relu(next(convs)(upsample_bilinear_align_corners(h, 2)))
            h = h + skips.pop()
            if stage < 3:
                h = block(h)
        h = upsample_bilinear_align_corners(h, 2)
        return torch.sigmoid(next(convs)(h))


class DeconvField(nn.Sequential):
    """The per-pixel deformable-offset net (``DAIN.py:506-527``; JAX's
    ``DeconvField``, ``mononet.py:166-176``): conv 3->64, ReLU, conv
    ->128, ReLU, conv ->``out_channels`` (reference children ``0``, ``2``,
    ``4``), the offsets of ``filter_interpolate_deformable``."""

    def __init__(self, out_channels: int = 32,
                 generator: torch.Generator | None = None):
        g = generator
        super().__init__(conv(3, 64, generator=g), nn.ReLU(),
                         conv(64, 128, generator=g), nn.ReLU(),
                         conv(128, out_channels, generator=g))
