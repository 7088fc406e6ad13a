"""PWC-DC optical-flow network, NCHW.

Counterpart of ``vfidkr_tpu/models/pwcnet.py:35-251`` (reference
``PWCNet/PWCNet.py:41-335``), with the parameter names of the reference
checkpoint (``conv1a.0.weight`` ... ``dc_conv7.weight``).  The reference's
``deconv2`` is never called and is left out.

- a 6-level siamese conv pyramid of 16/32/64/96/128/196 channels, each level
  ``conv(s=2) -> conv -> conv`` with LeakyReLU(0.1);
- per level from coarse to fine: an 81-channel cost volume over the other
  image's features, warped by the upsampled coarser flow -> LeakyReLU (both
  ``ops.correlation.cost_volume``, the kernel K13 on the card) -> a
  DenseNet block of 5 convs (128/128/96/64/32, newest output first) -> a
  2-channel flow -> 4x4/s2 deconvs of the flow and of a 2-channel feature;
  each dense conv with its LeakyReLU is ``ops.dense_conv`` (the kernel K10
  on the card); without autograd a level writes its five outputs straight
  into one buffer in the joined channel order, with no ``torch.cat``; the
  flow head ``predict_flow{lvl}`` is ``ops.flow_head`` (the kernel K11 on
  the card), which reads that buffer in place;
- a 7-conv dilated context network refines the finest flow;
- the output flow is at 1/4 of the input resolution and 1/20 of the pixel
  flow.

Its four parts run in profiler spans (``utils.profiling.span``):
``vfidkr/flow/pyramid``, and per level ``vfidkr/flow/cost_volume`` (the
warp and the correlation) and ``vfidkr/flow/decoder`` (the dense block, the
flow head and the deconvs that feed the next level; the head alone also in
``vfidkr/flow/heads``), then ``vfidkr/flow/refine`` (the dilated context
network and the final add).

Init: kaiming normal (fan_in) on every conv and deconv, zero bias.
"""

from __future__ import annotations

import torch
from torch import nn

from vfidkr_torch.models.layers import conv, deconv
from vfidkr_torch.ops import pwc_warp
from vfidkr_torch.ops.correlation import cost_volume
from vfidkr_torch.ops.dense_conv import dense_conv, dense_conv_into
from vfidkr_torch.ops.flow_head import flow_head
from vfidkr_torch.utils.profiling import span

MD = 4                          # cost-volume max displacement
_DENSE = (128, 128, 96, 64, 32)
_DENSE_OUT = sum(_DENSE)        # channels the dense block adds to its input
_NCORR = (2 * MD + 1) ** 2
# decoder input channels per level: cost volume + own features + upsampled
# flow and feature of the coarser level
_OD = {6: _NCORR, 5: _NCORR + 128 + 4, 4: _NCORR + 96 + 4,
       3: _NCORR + 64 + 4, 2: _NCORR + 32 + 4}
# how the upsampled coarser flow is scaled before it warps level lvl
_WARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}


def _conv_lrelu(cin, cout, stride=1, padding=1, dilation=1, generator=None):
    return nn.Sequential(
        conv(cin, cout, 3, stride, padding, dilation, init="kaiming",
             generator=generator),
        nn.LeakyReLU(0.1))


class PWCDCNet(nn.Module):
    """Input: two (B,3,H,W) frames with H, W divisible by 64; output: flow
    (B,2,H/4,W/4) at 1/20 of the pixel flow (callers multiply by 20)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        chans = [3, 16, 32, 64, 96, 128]
        for lvl in range(1, 6):
            cin, cout = chans[lvl - 1], chans[lvl]
            setattr(self, f"conv{lvl}a", _conv_lrelu(cin, cout, 2, generator=g))
            setattr(self, f"conv{lvl}aa", _conv_lrelu(cout, cout, generator=g))
            setattr(self, f"conv{lvl}b", _conv_lrelu(cout, cout, generator=g))
        self.conv6aa = _conv_lrelu(128, 196, 2, generator=g)
        self.conv6a = _conv_lrelu(196, 196, generator=g)
        self.conv6b = _conv_lrelu(196, 196, generator=g)

        for lvl, od in _OD.items():
            cin = od
            for i, cout in enumerate(_DENSE):
                setattr(self, f"conv{lvl}_{i}", _conv_lrelu(cin, cout, generator=g))
                cin += cout
            setattr(self, f"predict_flow{lvl}",
                    conv(cin, 2, init="kaiming", generator=g))
            if lvl > 2:
                setattr(self, f"deconv{lvl}", deconv(2, 2, generator=g))
                setattr(self, f"upfeat{lvl}", deconv(cin, 2, generator=g))

        dc_in = _OD[2] + sum(_DENSE)
        for i, (cin, cout, dil) in enumerate(
                [(dc_in, 128, 1), (128, 128, 2), (128, 128, 4), (128, 96, 8),
                 (96, 64, 16), (64, 32, 1)], start=1):
            setattr(self, f"dc_conv{i}",
                    _conv_lrelu(cin, cout, 1, dil, dil, generator=g))
        self.dc_conv7 = conv(32, 2, init="kaiming", generator=g)

    def _pyramid(self, im):
        feats = []
        x = im
        for lvl in range(1, 6):
            for s in ("a", "aa", "b"):
                x = getattr(self, f"conv{lvl}{s}")(x)
            feats.append(x)
        feats.append(self.conv6b(self.conv6a(self.conv6aa(x))))
        return feats

    def _corr(self, a, b):
        return cost_volume(a, b, MD)

    def _dense(self, lvl, x):
        """(N, od, H, W) -> (N, od + 448, H, W): each conv's output joined
        before its input, newest first.  Under autograd each conv's output
        is a fresh tensor and joined by ``torch.cat``; without, one buffer
        holds the level's input at its tail and each conv reads the
        buffer's channel suffix and writes the slot just before it."""
        convs = [getattr(self, f"conv{lvl}_{i}")[0]
                 for i in range(len(_DENSE))]
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for c in convs for p in (c.weight, c.bias))):
            for c in convs:
                x = torch.cat([dense_conv(x, c.weight, c.bias), x], 1)
            return x
        n, od, h, w = x.shape
        buf = x.new_empty((n, _DENSE_OUT + od, h, w))
        buf[:, _DENSE_OUT:].copy_(x)
        start = _DENSE_OUT
        for c in convs:
            dense_conv_into(buf, start, c.weight, c.bias)
            start -= c.out_channels
        return buf

    def _head(self, lvl, x):
        """The level's 2-channel flow from its dense block's output:
        ``predict_flow{lvl}``'s conv and bias, in the span
        ``vfidkr/flow/heads``."""
        m = getattr(self, f"predict_flow{lvl}")
        with span("vfidkr/flow/heads"):
            return flow_head(x, m.weight, m.bias)

    def _decode(self, pyr1, pyr2):
        with span("vfidkr/flow/cost_volume"):
            x = self._corr(pyr1[5], pyr2[5])
        with span("vfidkr/flow/decoder"):
            x = self._dense(6, x)
            flow = self._head(6, x)
            up_flow, up_feat = self.deconv6(flow), self.upfeat6(x)
        for lvl in (5, 4, 3, 2):
            f1, f2 = pyr1[lvl - 1], pyr2[lvl - 1]
            with span("vfidkr/flow/cost_volume"):
                corr = self._corr(f1, pwc_warp(f2, up_flow * _WARP_SCALE[lvl]))
            with span("vfidkr/flow/decoder"):
                x = self._dense(lvl, torch.cat([corr, f1, up_flow, up_feat],
                                               1))
                flow = self._head(lvl, x)
                if lvl > 2:
                    up_flow = getattr(self, f"deconv{lvl}")(flow)
                    up_feat = getattr(self, f"upfeat{lvl}")(x)
        with span("vfidkr/flow/refine"):
            ctx = x
            for i in range(1, 7):
                ctx = getattr(self, f"dc_conv{i}")(ctx)
            return flow + self.dc_conv7(ctx)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        with span("vfidkr/flow/pyramid"):
            pyr1, pyr2 = self._pyramid(im1), self._pyramid(im2)
        return self._decode(pyr1, pyr2)

    def bidirectional(self, im1: torch.Tensor, im2: torch.Tensor):
        """Flows im1->im2 and im2->im1, as ``forward`` gives them, with the
        pyramid run once over both frames and both directions decoded as
        one batch of 2B."""
        b = im1.shape[0]
        with span("vfidkr/flow/pyramid"):
            pyr = self._pyramid(torch.cat([im1, im2], 0))
            # batch order (im1, im2) decodes forward; swapped, backward
            swapped = [torch.cat([c[b:], c[:b]], 0) for c in pyr]
        flow = self._decode(pyr, swapped)
        return flow[:b], flow[b:]
