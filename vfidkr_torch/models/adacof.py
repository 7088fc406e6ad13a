"""AdaCoF: "AdaCoF: Adaptive Collaboration of Flows for Video Frame
Interpolation" (Lee, Kim, Chung, Pak, Ban and Lee, CVPR 2020,
arXiv:1907.10244), NCHW float32, at t = 0.5, at the widths of the authors'
public PyTorch version (github.com/HyeongminLEE/AdaCoF-pytorch,
``models/adacofnet.py``: ``KernelEstimation``, ``AdaCoFNet``).

A U-Net predicts, for every output pixel and each frame, F x F weights
and as many vertical and horizontal offsets; each frame is sampled
bilinearly at the F x F dilated grid points around the pixel, each moved by
its own offset, and weighted; an occlusion map blends the two frames' sums:

* the input: both frames less a per-channel mean (``INPUT_MEAN``, the
  public code's ``moduleNormalize``), joined;
* the U-Net (``models/unet.py``, SepConv's to the parameter): the encoder
  ``moduleConv1..5`` and the decoder ``moduleDeconv5..2`` with
  ``moduleUpsample5..2`` (bilinear x2 with ``align_corners=True``), ``x =
  d2 + c2``, 64 channels at half size;
* on ``x``, six heads of conv 64->64, ReLU, conv 64->64, ReLU, conv
  64->F^2, ReLU, bilinear x2 (``align_corners=True``), conv F^2->F^2:
  ``moduleWeight1/2`` end in a softmax over the F^2 channels (the weights
  W), ``moduleAlpha1/2`` and ``moduleBeta1/2`` are the vertical and
  horizontal offsets (frame 0's, then frame 2's);
* ``moduleOcclusion``: three (conv 64->64, ReLU), bilinear x2, conv 64->1,
  sigmoid: V;
* the output ``V T_0 + (1 - V) T_2``, T_k frame k's weighted sum of its
  samples (``ops.adacof.adacof_pair``: the kernel K14 on the card, the
  plain version on the CPU).

``AdaCoFPlus`` is the paper's larger setting, F = 11 taps a side and
dilation D = 2 (22,933,219 parameters); ``AdaCoFPlus(kernel_size=5,
dilation=1)`` is its AdaCoF (21,843,427).  The children carry
``adacofnet.py``'s names and ``nn.Sequential`` indices (a published
checkpoint with its ``get_kernel.`` prefix dropped loads with
``strict=True``).  The frames' sides must be multiples of 32 (the five
pools); the video driver's padding gives them.  The port's own
initialisation (without a checkpoint) is kaiming normal, biases 0.

``forward(i0, i2)`` returns ``{"outputs": [out]}``: one frame, t = 0.5
only, float32 only, evaluation only (K14 has no backward).  Its convs need
cuDNN's autotuner, as SepConv's do (``CUDNN_BENCHMARK``; its heads are
121 -> 121 convs at full size).  It runs in the span ``vfidkr/forward``,
each of its ops in one of ``vfidkr/adacof/{encoder,decoder,kernels,
sampling}`` (``utils.profiling.span``).
"""

from __future__ import annotations

import torch
from torch import nn

from vfidkr_torch.models.layers import conv, lane_dtype
from vfidkr_torch.models.unet import UNet, Upsample2x, subnet
from vfidkr_torch.ops.adacof import adacof_pair
from vfidkr_torch.utils.profiling import span

KERNEL_SIZE = 11        # AdaCoF+'s F
DILATION = 2            # AdaCoF+'s D
# ``moduleNormalize``'s per-channel means, subtracted from both frames
INPUT_MEAN = (0.4631, 0.4352, 0.3990)


def subnet_weight(taps: int, g) -> nn.Sequential:
    """``Subnet_weight``: ``Subnet_offset`` and a softmax over the F^2
    channels."""
    return nn.Sequential(*subnet(taps, g, align_corners=True),
                         nn.Softmax(dim=1))


def subnet_occlusion(g) -> nn.Sequential:
    """``Subnet_occlusion``: three (conv, ReLU), bilinear x2, conv 64 -> 1,
    sigmoid."""
    conv3 = lambda cin, cout: conv(cin, cout, init="kaiming", generator=g)
    return nn.Sequential(conv3(64, 64), nn.ReLU(), conv3(64, 64), nn.ReLU(),
                         conv3(64, 64), nn.ReLU(),
                         Upsample2x(align_corners=True), conv3(64, 1),
                         nn.Sigmoid())


class AdaCoFPlus(UNet):
    # the only time step it interpolates at (``ModelConfig`` checks it)
    TIME_STEP = 0.5
    # its convs need cuDNN's autotuner (``ModelConfig.build`` turns it on)
    CUDNN_BENCHMARK = True

    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: str = "float32",
                 kernel_size: int = KERNEL_SIZE, dilation: int = DILATION):
        super().__init__()
        if lane_dtype(compute_dtype) != torch.float32:
            raise ValueError("AdaCoF runs in float32 only")
        if kernel_size % 2 == 0 or kernel_size < 1 or dilation < 1:
            raise ValueError(f"kernel_size must be odd and dilation "
                             f"positive, got {kernel_size}, {dilation}")
        self.kernel_size, self.dilation = kernel_size, dilation
        g, taps = generator, kernel_size * kernel_size
        self.add_unet("module", True, ("vfidkr/adacof/encoder",
                                       "vfidkr/adacof/decoder"), g,
                      INPUT_MEAN)
        for k in (1, 2):
            setattr(self, f"moduleWeight{k}", subnet_weight(taps, g))
            setattr(self, f"moduleAlpha{k}",
                    subnet(taps, g, align_corners=True))
            setattr(self, f"moduleBeta{k}",
                    subnet(taps, g, align_corners=True))
        self.moduleOcclusion = subnet_occlusion(g)

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 32.  Returns
        ``{"outputs": [out]}``, out (B,3,H,W)."""
        if i0.shape[2] % 32 or i0.shape[3] % 32:
            raise ValueError(f"AdaCoF needs sides divisible by 32, got "
                             f"{tuple(i0.shape[2:])}")
        with span("vfidkr/forward"):
            x = self.unet(i0, i2)
            with span("vfidkr/adacof/kernels"):
                w0, a0, b0 = (self.moduleWeight1(x), self.moduleAlpha1(x),
                              self.moduleBeta1(x))
                w2, a2, b2 = (self.moduleWeight2(x), self.moduleAlpha2(x),
                              self.moduleBeta2(x))
                occ = self.moduleOcclusion(x)
            with span("vfidkr/adacof/sampling"):
                out = adacof_pair(i0, w0, a0, b0, i2, w2, a2, b2, occ,
                                  self.dilation)
        return {"outputs": [out]}
