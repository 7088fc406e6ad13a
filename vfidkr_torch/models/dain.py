"""DAIN eval forward, NCHW float32.

Counterpart of ``DAIN.__call__`` in ``vfidkr_tpu/models/dain.py:119-176``
with ``train=False`` (reference ``networks/DAIN.py:101-294``), at t = 0.5:

1. MonoNet5 and two branch heads on ``cat([i0, i2])``: the 4x4 kernels;
2. PWC-Net flows in both directions, pyramid shared, directions batched;
3. ``upsample_bilinear(flows * (20 * 0.5), 4)``;
4. flow projection with the inference hole fill;
5. one filter interpolation of both frames, batched as 2B;
6. ``cur = ref0 / 2 + ref2 / 2``;
7. the 45-channel rectifier, added to ``cur``.

Batching both directions means each of the three CUDA kernels launches once
per forward.  The children carry the reference checkpoint's names
(``initScaleNets_filter``, ``initScaleNets_filter1/2``, ``flownets``,
``rectifyNet``).
"""

from __future__ import annotations

import torch
from torch import nn

from vfidkr_torch.models.layers import upsample_bilinear
from vfidkr_torch.models.mononet import BranchHead, MonoNet5
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.models.resblock import MultipleBasicBlock
from vfidkr_torch.ops import filter_interpolate, flow_project

DIV_FLOW = 20.0
TIMESTEP = 0.5


class DAIN(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.initScaleNets_filter = MonoNet5(generator=g)
        self.initScaleNets_filter1 = BranchHead(generator=g)
        self.initScaleNets_filter2 = BranchHead(generator=g)
        self.flownets = PWCDCNet(generator=g)
        self.rectifyNet = MultipleBasicBlock(45, 128, generator=g)

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 64.

        Returns ``{"outputs": [cur_output, rectified], "offsets": [off0,
        off1], "filters": [filt0, filt1]}``."""
        b = i0.shape[0]
        trunk = self.initScaleNets_filter(torch.cat([i0, i2], 1))
        filt0 = self.initScaleNets_filter1(trunk)
        filt1 = self.initScaleNets_filter2(trunk)

        raw_fwd, raw_bwd = self.flownets.bidirectional(i0, i2)
        flows = upsample_bilinear(
            torch.cat([raw_fwd, raw_bwd], 0) * (DIV_FLOW * TIMESTEP), 4)

        offs = flow_project(flows)
        off0, off1 = offs[:b], offs[b:]

        refs = filter_interpolate(torch.cat([i0, i2], 0), offs,
                                  torch.cat([filt0, filt1], 0))
        ref0, ref2 = refs[:b], refs[b:]
        cur_output = ref0 / 2.0 + ref2 / 2.0

        rectify_input = torch.cat(
            [cur_output, ref0, ref2, off0, off1, filt0, filt1], 1)
        rectified = self.rectifyNet(rectify_input) + cur_output
        return {"outputs": [cur_output, rectified],
                "offsets": [off0, off1],
                "filters": [filt0, filt1]}
