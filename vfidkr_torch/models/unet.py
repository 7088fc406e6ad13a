"""The U-Net that SepConv (``models/sepconv.py``) and AdaCoF
(``models/adacof.py``) share, NCHW float32: SepConv's encoder and decoder
(github.com/sniklaus/sepconv-slomo ``run.py``), which AdaCoF's
``KernelEstimation`` (github.com/HyeongminLEE/AdaCoF-pytorch,
``models/adacofnet.py``) repeats to the parameter.  All convs are 3x3,
stride 1, padding 1:

* ``Basic(i, o)``: conv i->o, ReLU, conv o->o, ReLU, conv o->o, ReLU;
* ``Upsample(c)``: bilinear x2, conv c->c, ReLU;
* the encoder ``Conv1..5`` (6->32->64->128->256->512), each level's input
  the 2x2 average pool of the one before; the decoder ``Deconv5..2`` with
  ``Upsample5..2``, the encoder's levels added as skips; the output
  ``d2 + c2``, 64 channels at half the frame's size;
* ``subnet(taps)``, the heads both networks put on that output.

The two differ only in the upsample's corners: SepConv's bilinear x2 has
``align_corners=False``, AdaCoF's ``True``; and in their children's
prefix: ``net`` (``netConv1``, ...) and ``module`` (``moduleConv1``, ...).
``UNet.add_unet`` gives a network the 21,168,480 parameters under its
prefix (and AdaCoF's input mean, subtracted from the frames first), and
``UNet.unet`` runs them inside the network's own encoder and decoder
spans (``utils.profiling.span``), so an optimisation of this path shows in
both networks' cells.
"""

from __future__ import annotations

import torch
from torch import nn

from vfidkr_torch.models.layers import (avg_pool_2x2, conv,
                                        upsample_bilinear,
                                        upsample_bilinear_align_corners)
from vfidkr_torch.utils.profiling import span

ENCODER = (6, 32, 64, 128, 256, 512)
# (level, in, out) of each decoder level, from the deepest
DECODER = ((5, 512, 512), (4, 512, 256), (3, 256, 128), (2, 128, 64))


class Upsample2x(nn.Module):
    """``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=...)``
    (no parameters: it holds the public code's place in the
    ``Sequential``)."""

    def __init__(self, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.align_corners:
            return upsample_bilinear_align_corners(x, 2)
        return upsample_bilinear(x, 2)


def basic(cin: int, cout: int, g) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, init="kaiming", generator=g),
                         nn.ReLU(),
                         conv(cout, cout, init="kaiming", generator=g),
                         nn.ReLU(),
                         conv(cout, cout, init="kaiming", generator=g),
                         nn.ReLU())


def upsample(c: int, g, align_corners: bool = False) -> nn.Sequential:
    return nn.Sequential(Upsample2x(align_corners),
                         conv(c, c, init="kaiming", generator=g), nn.ReLU())


def subnet(taps: int, g, align_corners: bool = False) -> nn.Sequential:
    """A head on the U-Net's output: conv 64->64, ReLU, conv 64->64, ReLU,
    conv 64->taps, ReLU, bilinear x2, conv taps->taps (SepConv's
    ``Subnet``, AdaCoF's ``Subnet_offset``)."""
    return nn.Sequential(conv(64, 64, init="kaiming", generator=g), nn.ReLU(),
                         conv(64, 64, init="kaiming", generator=g), nn.ReLU(),
                         conv(64, taps, init="kaiming", generator=g),
                         nn.ReLU(), Upsample2x(align_corners),
                         conv(taps, taps, init="kaiming", generator=g))


class UNet(nn.Module):
    """A network on the shared U-Net: ``add_unet`` in its ``__init__``,
    ``unet`` in its forward."""

    def add_unet(self, prefix: str, align_corners: bool, spans: tuple,
                 g=None, input_mean: tuple | None = None) -> None:
        """Children ``{prefix}Conv1..5``, ``{prefix}Deconv5..2`` and
        ``{prefix}Upsample5..2`` (built in that order from ``g``); ``spans``
        names the encoder's and the decoder's span; ``input_mean``, where
        given, is subtracted from each frame's channels first."""
        self._unet = (prefix, spans)
        # both frames' means, (1,6,1,1): a plain attribute, not a buffer,
        # so a model built on the meta device and given its storage by
        # ``to_empty`` keeps the values; moved to the frames' device and
        # dtype once
        self._input_mean = None if input_mean is None else torch.tensor(
            tuple(input_mean) * 2, dtype=torch.float64,
            device="cpu").view(1, 6, 1, 1)
        for k in range(1, 6):
            setattr(self, f"{prefix}Conv{k}", basic(ENCODER[k - 1],
                                                    ENCODER[k], g))
        for k, cin, cout in DECODER:
            setattr(self, f"{prefix}Deconv{k}", basic(cin, cout, g))
        for k, _, cout in DECODER:
            setattr(self, f"{prefix}Upsample{k}",
                    upsample(cout, g, align_corners))

    def unet(self, i0: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
        """cat(i0, i2) (less the input's mean, where given) through the
        encoder and decoder -> (B,64,H/2,W/2)."""
        prefix, (encoder, decoder) = self._unet
        child = lambda name: getattr(self, prefix + name)
        with span(encoder):
            x = torch.cat([i0, i2], 1)
            mean = self._input_mean
            if mean is not None:
                if (mean.device, mean.dtype) != (x.device, x.dtype):
                    mean = self._input_mean = mean.to(x)
                x = x - mean
            c1 = child("Conv1")(x)
            c2 = child("Conv2")(avg_pool_2x2(c1))
            c3 = child("Conv3")(avg_pool_2x2(c2))
            c4 = child("Conv4")(avg_pool_2x2(c3))
            c5 = child("Conv5")(avg_pool_2x2(c4))
        with span(decoder):
            d5 = child("Upsample5")(child("Deconv5")(avg_pool_2x2(c5)))
            d4 = child("Upsample4")(child("Deconv4")(d5 + c5))
            d3 = child("Upsample3")(child("Deconv3")(d4 + c4))
            d2 = child("Upsample2")(child("Deconv2")(d3 + c3))
            return d2 + c2
