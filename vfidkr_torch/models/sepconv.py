"""SepConv: "Video Frame Interpolation via Adaptive Separable Convolution"
(Niklaus, Mai and Liu, ICCV 2017, arXiv:1708.01692), NCHW float32, at the
widths of the first author's public PyTorch version
(github.com/sniklaus/sepconv-slomo, ``run.py``, class ``Network``).

A U-Net predicts, for every output pixel and each of the two frames, a
vertical and a horizontal 1-D kernel of 51 taps; each frame, replication-
padded by 25 px, is convolved with its own 51x51 separable kernel at every
pixel, and the two results are summed.  All convs are 3x3, stride 1,
padding 1:

* ``Basic(i, o)``: conv i->o, ReLU, conv o->o, ReLU, conv o->o, ReLU;
* ``Upsample(c)``: bilinear x2 (``align_corners=False``), conv c->c, ReLU;
* ``Subnet``: conv 64->64, ReLU, conv 64->64, ReLU, conv 64->51, ReLU,
  bilinear x2, conv 51->51;
* the encoder ``netConv1..5`` (6->32->64->128->256->512), each level's input
  the 2x2 average pool of the one before; the decoder ``netDeconv5..2``
  with ``netUpsample5..2``, the skips added; ``x = d2 + c2`` feeds the four
  subnets ``netVertical1/2`` and ``netHorizontal1/2``.

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
from torch import nn

from vfidkr_torch.models.layers import (avg_pool_2x2, conv, lane_dtype,
                                        upsample_bilinear)
from vfidkr_torch.ops.separable_conv import separable_conv_pair
from vfidkr_torch.utils.profiling import span

FILTER_SIZE = 51
ENCODER = (6, 32, 64, 128, 256, 512)
DECODER = (512, 256, 128, 64)


class Upsample2x(nn.Module):
    """``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False)``
    (no parameters: it holds ``run.py``'s place in the ``Sequential``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear(x, 2)


def basic(cin: int, cout: int, g) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, init="kaiming", generator=g),
                         nn.ReLU(),
                         conv(cout, cout, init="kaiming", generator=g),
                         nn.ReLU(),
                         conv(cout, cout, init="kaiming", generator=g),
                         nn.ReLU())


def upsample(c: int, g) -> nn.Sequential:
    return nn.Sequential(Upsample2x(),
                         conv(c, c, init="kaiming", generator=g), nn.ReLU())


def subnet(g) -> nn.Sequential:
    fs = FILTER_SIZE
    return nn.Sequential(conv(64, 64, init="kaiming", generator=g), nn.ReLU(),
                         conv(64, 64, init="kaiming", generator=g), nn.ReLU(),
                         conv(64, fs, init="kaiming", generator=g), nn.ReLU(),
                         Upsample2x(),
                         conv(fs, fs, init="kaiming", generator=g))


class SepConv(nn.Module):
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
        for k in range(1, 6):
            setattr(self, f"netConv{k}", basic(ENCODER[k - 1], ENCODER[k], g))
        for k, cin, cout in ((5, 512, 512), (4, 512, 256), (3, 256, 128),
                             (2, 128, 64)):
            setattr(self, f"netDeconv{k}", basic(cin, cout, g))
        for k, c in zip((5, 4, 3, 2), DECODER):
            setattr(self, f"netUpsample{k}", upsample(c, g))
        self.netVertical1 = subnet(g)
        self.netVertical2 = subnet(g)
        self.netHorizontal1 = subnet(g)
        self.netHorizontal2 = subnet(g)

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 32.  Returns
        ``{"outputs": [out]}``, out (B,3,H,W)."""
        if i0.shape[2] % 32 or i0.shape[3] % 32:
            raise ValueError(f"SepConv needs sides divisible by 32, got "
                             f"{tuple(i0.shape[2:])}")
        with span("vfidkr/forward"):
            with span("vfidkr/sepconv/encoder"):
                c1 = self.netConv1(torch.cat([i0, i2], 1))
                c2 = self.netConv2(avg_pool_2x2(c1))
                c3 = self.netConv3(avg_pool_2x2(c2))
                c4 = self.netConv4(avg_pool_2x2(c3))
                c5 = self.netConv5(avg_pool_2x2(c4))
            with span("vfidkr/sepconv/decoder"):
                d5 = self.netUpsample5(self.netDeconv5(avg_pool_2x2(c5)))
                d4 = self.netUpsample4(self.netDeconv4(d5 + c5))
                d3 = self.netUpsample3(self.netDeconv3(d4 + c4))
                d2 = self.netUpsample2(self.netDeconv2(d3 + c3))
                x = d2 + c2
            with span("vfidkr/sepconv/kernels"):
                v1, v2 = self.netVertical1(x), self.netVertical2(x)
                h1, h2 = self.netHorizontal1(x), self.netHorizontal2(x)
            with span("vfidkr/sepconv/local_conv"):
                out = separable_conv_pair(i0, v1, h1, i2, v2, h2)
        return {"outputs": [out]}
