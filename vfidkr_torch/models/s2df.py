"""S2DF context feature extractor (``S2DF_3dense``), NCHW.

Counterpart of ``vfidkr_tpu/models/s2df.py:35-55`` (reference
``S2D_models/S2DF.py:97-222``, ``S2DF_3dense``: three blocks, dense,
dilated): block 1 is a bias-free 7x7 conv to 64 channels + ReLU, blocks 2
and 3 are bias-free residual blocks whose first convs are dilated by 4 and
8; the output is ``[rgb, f1, f2, f3]``, the input and each block's output,
3 + 3 x 64 = 195 channels.
Parameter names are the reference's (``block1.0``, ``block2.conv1``, ...).
Init: normal(0, sqrt(2 / (k*k*out))).

With ``compute_dtype=torch.bfloat16`` (the bf16 eval lane) the convs and
residual blocks run in bf16 (the residual added in bf16, JAX's chained
lane); the rgb input passes through exactly and the features are cast back
to float32, so the output is float32 in both lanes.
"""

from __future__ import annotations

import torch
from torch import nn

from vfidkr_torch.models.layers import conv
from vfidkr_torch.models.resblock import ResBasicBlock

DILATIONS = (4, 8)      # of blocks 2 and 3


class S2DF(nn.Module):
    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        g, dt = generator, compute_dtype
        self.block1 = nn.Sequential(
            conv(3, 64, 7, 1, 3, bias=False, init="msra", generator=g,
                 compute_dtype=dt),
            nn.ReLU())
        for i, d in enumerate(DILATIONS, start=2):
            self.add_module(f"block{i}",
                            ResBasicBlock(64, d, generator=g, compute_dtype=dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B,3,H,W) -> (B,195,H,W)."""
        feats = [x, self.block1(x)]
        for i in range(2, 2 + len(DILATIONS)):
            feats.append(self._modules[f"block{i}"](feats[-1]))
        return torch.cat([x] + [f.float() for f in feats[1:]], 1)


def s2df_3dense() -> S2DF:
    """The reference's ``S2DF_3dense`` (``vfidkr_tpu/models/s2df.py:58``)."""
    return S2DF()
