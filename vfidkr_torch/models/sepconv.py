"""SepConv: "Video Frame Interpolation via Adaptive Separable Convolution"
(Niklaus, Mai and Liu, ICCV 2017, arXiv:1708.01692), NCHW float32, at the
widths of the first author's public PyTorch version
(github.com/sniklaus/sepconv-slomo, ``run.py``, class ``Network``).

A U-Net predicts, for every output pixel and each of the two frames, a
vertical and a horizontal 1-D kernel of 51 taps; each frame, replication-
padded by 25 px, is convolved with its own 51x51 separable kernel at every
pixel, and the two results are summed.

* the U-Net (``models/unet.py``, shared with AdaCoF): the encoder
  ``netConv1..5`` and the decoder ``netDeconv5..2`` with ``netUpsample5..2``
  (bilinear x2 with ``align_corners=False``), ``x = d2 + c2``;
* four subnets ``netVertical1/2`` and ``netHorizontal1/2`` on ``x``: conv
  64->64, ReLU, conv 64->64, ReLU, conv 64->51, ReLU, bilinear x2, conv
  51->51 (3x3 convs, stride 1, padding 1).

The children carry ``run.py``'s names and ``nn.Sequential`` indices (a
published ``network-*.pytorch`` with ``module`` renamed ``net``, as
``run.py`` renames it, loads with ``strict=True``): 21.7 M parameters.
The frames' sides must be multiples of 32 (the five pools); ``run.py`` pads
its own input, here the driver's padding gives it.  The port's own
initialisation (without a checkpoint) is kaiming normal, biases 0.

``forward(i0, i2)`` returns ``{"outputs": [out]}``: one frame, t = 0.5
only.  Its convolutions need cuDNN's autotuner
(``torch.backends.cudnn.benchmark``): with it off, cuDNN's heuristic takes
its FFT tiling for ``netDeconv3``'s first conv (256 -> 128 at 1/8 of the
frame), some 33,000 launches and 0.28 s at 1984 x 1152, against about
0.5 ms for its implicit GEMM.  The class says so (``CUDNN_BENCHMARK``), and
``config.ModelConfig.build`` sets the process's flag once, before any
forward; a video's frames all have one size, so each shape is tuned once,
on the first pair.  It runs in the profiler span
``vfidkr/forward``, its ops in
``vfidkr/sepconv/{encoder,decoder,kernels,local_conv}``
(``utils.profiling.span``).  The local convolution is
``ops.separable_conv.separable_conv_pair``: the kernel K9 on the card, the
plain ``separable_conv`` on the CPU.  SepConv runs in float32 only.
"""

from __future__ import annotations

import torch

from vfidkr_torch.models.layers import lane_dtype
from vfidkr_torch.models.unet import UNet, subnet
from vfidkr_torch.ops.separable_conv import separable_conv_pair
from vfidkr_torch.utils.profiling import span

FILTER_SIZE = 51


class SepConv(UNet):
    # the only time step it interpolates at (``ModelConfig`` checks it)
    TIME_STEP = 0.5
    # its convs need cuDNN's autotuner (``ModelConfig.build`` turns it on)
    CUDNN_BENCHMARK = True

    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        if lane_dtype(compute_dtype) != torch.float32:
            raise ValueError("SepConv runs in float32 only")
        g = generator
        self.add_unet("net", False, ("vfidkr/sepconv/encoder",
                                     "vfidkr/sepconv/decoder"), g)
        self.netVertical1 = subnet(FILTER_SIZE, g)
        self.netVertical2 = subnet(FILTER_SIZE, g)
        self.netHorizontal1 = subnet(FILTER_SIZE, g)
        self.netHorizontal2 = subnet(FILTER_SIZE, g)

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 32.  Returns
        ``{"outputs": [out]}``, out (B,3,H,W)."""
        if i0.shape[2] % 32 or i0.shape[3] % 32:
            raise ValueError(f"SepConv needs sides divisible by 32, got "
                             f"{tuple(i0.shape[2:])}")
        with span("vfidkr/forward"):
            x = self.unet(i0, i2)
            with span("vfidkr/sepconv/kernels"):
                v1, v2 = self.netVertical1(x), self.netVertical2(x)
                h1, h2 = self.netHorizontal1(x), self.netHorizontal2(x)
            with span("vfidkr/sepconv/local_conv"):
                out = separable_conv_pair(i0, v1, h1, i2, v2, h2)
        return {"outputs": [out]}
