"""Rectification network (``MultipleBasicBlock_4``), NCHW.

Counterpart of ``vfidkr_tpu/models/resblock.py:55-90`` and
``ResBasicBlock`` of ``vfidkr_tpu/models/s2df.py:18-32`` (reference
``Resblock/BasicBlock.py``), chained evaluation only: 7x7 conv (bias) + ReLU,
three bias-free residual blocks, 3x3 conv to 3 channels.  Parameter names
are the reference's (``block1.0``, ``block2.conv1``, ..., ``block5.0``).
Init: normal(0, sqrt(2 / (k*k*out))), zero bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vfidkr_torch.models.layers import conv


class ResBasicBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 -> + input -> ReLU, bias-free; the first
    conv dilated by ``dilation`` and padded by as much (S2DF's blocks)."""

    def __init__(self, planes: int, dilation: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = conv(planes, planes, 3, 1, dilation, dilation,
                          bias=False, init="msra", generator=generator)
        self.conv2 = conv(planes, planes, 3, 1, 1, 1, bias=False, init="msra",
                          generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(x))) + x)


class MultipleBasicBlock(nn.Module):
    def __init__(self, input_dim: int = 45, intermediate: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.block1 = nn.Sequential(
            conv(input_dim, intermediate, 7, 1, 3, init="msra", generator=g),
            nn.ReLU())
        self.block2 = ResBasicBlock(intermediate, generator=g)
        self.block3 = ResBasicBlock(intermediate, generator=g)
        self.block4 = ResBasicBlock(intermediate, generator=g)
        self.block5 = nn.Sequential(
            conv(intermediate, 3, 3, 1, 1, init="msra", generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block4(self.block3(self.block2(self.block1(x))))
        return self.block5(h)
