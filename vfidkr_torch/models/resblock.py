"""Rectification network (``MultipleBasicBlock_4``), NCHW.

Counterpart of ``vfidkr_tpu/models/resblock.py:55-90`` and
``ResBasicBlock`` of ``vfidkr_tpu/models/s2df.py:18-32`` (reference
``Resblock/BasicBlock.py``): 7x7 conv (bias) + ReLU, three bias-free
residual blocks, 3x3 conv to 3 channels.  Parameter names are the
reference's (``block1.0``, ``block2.conv1``, ..., ``block5.0``).
Init: normal(0, sqrt(2 / (k*k*out))), zero bias.

In float32 the blocks are chained, the head (block 1's conv, bias and ReLU)
through ``rectify_head`` (``vfidkr_torch/ops/conv_head.py``, the kernel K8 on
CUDA tensors); its parameters stay ``block1.0.weight`` and ``block1.0.bias``.
In the bf16 eval lane
(``compute_dtype=torch.bfloat16``) blocks 1 and 5 run in bf16 and the
three residual blocks run as ``fused_resblocks``
(``vfidkr_torch/ops/rectify.py``, the kernel K4), the semantics of the JAX
package's fused branch (``resblock.py:60-85``, ``rect_impl="fused"``),
which its bf16 lane takes on the TPU; the output is bf16.  A
``ResBasicBlock`` of its own (S2DF's) keeps the chained bf16 semantics:
the residual is added in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vfidkr_torch.models.layers import conv
from vfidkr_torch.ops.conv_head import rectify_head
from vfidkr_torch.ops.rectify import fused_resblocks
from vfidkr_torch.utils.profiling import span


class ResBasicBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 -> + input -> ReLU, bias-free; the first
    conv dilated by ``dilation`` and padded by as much (S2DF's blocks)."""

    def __init__(self, planes: int, dilation: int = 1,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        g, dt = generator, compute_dtype
        self.conv1 = conv(planes, planes, 3, 1, dilation, dilation,
                          bias=False, init="msra", generator=g,
                          compute_dtype=dt)
        self.conv2 = conv(planes, planes, 3, 1, 1, 1, bias=False, init="msra",
                          generator=g, compute_dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(x))) + x)


class MultipleBasicBlock(nn.Module):
    def __init__(self, input_dim: int = 45, intermediate: int = 128,
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        g, dt = generator, compute_dtype
        self.compute_dtype = dt
        self.block1 = nn.Sequential(
            conv(input_dim, intermediate, 7, 1, 3, init="msra", generator=g,
                 compute_dtype=dt),
            nn.ReLU())
        self.block2 = ResBasicBlock(intermediate, generator=g)
        self.block3 = ResBasicBlock(intermediate, generator=g)
        self.block4 = ResBasicBlock(intermediate, generator=g)
        self.block5 = nn.Sequential(
            conv(intermediate, 3, 3, 1, 1, init="msra", generator=g,
                 compute_dtype=dt))

    def trunk_weights(self) -> torch.Tensor:
        """The residual blocks' six conv weights, (6,128,128,3,3) bf16 in
        conv1/conv2 order of blocks 2, 3, 4: ``fused_resblocks``' ``w6``."""
        return torch.stack([c.weight for blk in (self.block2, self.block3,
                                                 self.block4)
                            for c in (blk.conv1, blk.conv2)]).bfloat16()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vfidkr/rectifier/head"):
            if self.compute_dtype == torch.float32:
                head = self.block1[0]
                h = rectify_head(x, head.weight, head.bias)
            else:
                h = self.block1(x)
        if self.compute_dtype == torch.float32:
            h = self.block4(self.block3(self.block2(h)))
        else:
            # on CUDA the trunk returns channels-last; block5 takes it as it
            # is, and the rectifier returns NCHW as the float32 lane does
            h = fused_resblocks(h, self.trunk_weights())
            return self.block5(h).contiguous()
        return self.block5(h)


def multiple_basic_block_4(intermediate: int = 128) -> MultipleBasicBlock:
    """The reference's ``MultipleBasicBlock_4``, DAIN's rectifier
    (``vfidkr_tpu/models/resblock.py:93``)."""
    return MultipleBasicBlock(intermediate=intermediate)
