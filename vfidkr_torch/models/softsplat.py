"""SoftSplat: "Softmax Splatting for Video Frame Interpolation" (Niklaus and
Liu, CVPR 2020, arXiv:2003.05534), NCHW float32, at t = 0.5.

1. Flow (child ``flownets``, the port's PWC-Net, DAIN's child of the same
   name): F0->1 and F1->0 by ``bidirectional``, x 20 and a bilinear x4
   upsample to full size, as DAIN's ``vfidkr/upsample`` does.
2. Importance metric: ``Z0 = alpha * mean_c |I0 - backwarp(I1, F0->1)|``
   and Z1 with the frames swapped (``ops.warp.backwarp``: bilinear at
   exactly x + F, zero outside the frame); ``alpha`` one trained scalar;
   Z clipped to [-20, 20], as the public operator's example clips it.
3. Feature pyramid (child ``extractor``), both frames as one batch: three
   levels of conv, PReLU, conv, PReLU (3 -> 32, 32 -> 64 with stride 2,
   64 -> 96 with stride 2), 3x3 convs, PReLU a parameter a channel.
4. Softmax splatting (``ops.softsplat.softmax_splat``): at level k (1 to 3)
   cat(I, L1) (35 channels), L2 and L3 of each frame move by t F0->1 and
   (1 - t) F1->0, the flow downsampled bilinearly to the level
   (``align_corners=False``) and scaled by 2^-(k-1), Z downsampled alike
   and not scaled; both directions of a level in one call.
5. GridNet (child ``synthesis``; Fourure et al., arXiv:1707.07958, as
   CtxSyn, arXiv:1803.10967, and SoftSplat size it): rows 0, 1, 2 of 32,
   64, 96 channels at 1/1, 1/2, 1/4 size, columns 0-5.  Row r's column 0
   takes an input block (conv, PReLU, conv) on both directions' level r +
   1; lateral blocks (PReLU, conv, PReLU, conv, plus the identity) join
   neighbouring columns; columns 0-2 feed each row below through a down
   block (PReLU, conv with stride 2, PReLU, conv), columns 3-5 each row
   above through an up block (bilinear x2, PReLU, conv, PReLU, conv);
   incoming paths are summed at each node.  The frame is PReLU and conv
   32 -> 3 of row 0, column 5.

The paper's variant that refines Z with a small U-Net gives no widths for
it and is not built.  The port's own initialisation (no published weights
exist) is kaiming normal for every conv, biases 0, PReLU slopes 0.25,
alpha -20 (the public operator's example).

``forward(i0, i2)`` returns ``{"outputs": [frame]}``.  It runs in the span
``vfidkr/forward``, each of its ops in one of ``vfidkr/flow`` (PWC-Net's
own ``vfidkr/flow/*`` inside), ``vfidkr/upsample`` and
``vfidkr/softsplat/{metric,pyramid,splat,synthesis}``
(``utils.profiling.span``).  The frames' sides must be multiples of 64
(PWC-Net); the video driver's padding gives them.  Evaluation only: the
splat's kernel K12 has no backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vfidkr_torch.models.dain import DIV_FLOW
from vfidkr_torch.models.layers import conv, lane_dtype, upsample_bilinear
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.models.unet import Upsample2x
from vfidkr_torch.ops.softsplat import softmax_splat
from vfidkr_torch.ops.warp import backwarp
from vfidkr_torch.utils.profiling import span

TIMESTEP = 0.5
ALPHA = -20.0           # the public operator's example
Z_CLIP = 20.0
PYRAMID = (32, 64, 96)  # the pyramid's and GridNet's rows
COLUMNS = 6
PRELU_INIT = 0.25


def _prelu(c: int) -> nn.PReLU:
    return nn.PReLU(c, init=PRELU_INIT)


def _conv(cin, cout, g, stride=1):
    return conv(cin, cout, stride=stride, init="kaiming", generator=g)


def pyramid_level(cin: int, cout: int, stride: int, g) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, g, stride), _prelu(cout),
                         _conv(cout, cout, g), _prelu(cout))


def input_block(cin: int, cout: int, g) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, g), _prelu(cout),
                         _conv(cout, cout, g))


def lateral_block(c: int, g) -> nn.Sequential:
    """PReLU, conv, PReLU, conv; the identity is added by ``GridNet``."""
    return nn.Sequential(_prelu(c), _conv(c, c, g), _prelu(c),
                         _conv(c, c, g))


def down_block(cin: int, cout: int, g) -> nn.Sequential:
    return nn.Sequential(_prelu(cin), _conv(cin, cout, g, 2), _prelu(cout),
                         _conv(cout, cout, g))


def up_block(cin: int, cout: int, g) -> nn.Sequential:
    return nn.Sequential(Upsample2x(), _prelu(cin), _conv(cin, cout, g),
                         _prelu(cout), _conv(cout, cout, g))


class Extractor(nn.Module):
    """The feature pyramid: ``level1..3``."""

    def __init__(self, g=None):
        super().__init__()
        cin = 3
        for k, c in enumerate(PYRAMID, 1):
            setattr(self, f"level{k}",
                    pyramid_level(cin, c, 1 if k == 1 else 2, g))
            cin = c

    def forward(self, x: torch.Tensor) -> list:
        feats = []
        for k in range(1, len(PYRAMID) + 1):
            x = getattr(self, f"level{k}")(x)
            feats.append(x)
        return feats


class GridNet(nn.Module):
    """Rows of ``PYRAMID`` channels, ``COLUMNS`` columns: ``input{r}``,
    ``lateral{r}{c}`` (into column c of row r), ``down{r}{c}`` (into row
    r at column c, c < 3), ``up{r}{c}`` (into row r at column c, c >= 3),
    ``output``."""

    def __init__(self, inputs, g=None):
        super().__init__()
        rows, half = len(PYRAMID), COLUMNS // 2
        for r, c in enumerate(PYRAMID):
            setattr(self, f"input{r}", input_block(inputs[r], c, g))
            for col in range(1, COLUMNS):
                setattr(self, f"lateral{r}{col}", lateral_block(c, g))
        for r in range(1, rows):
            for col in range(half):
                setattr(self, f"down{r}{col}",
                        down_block(PYRAMID[r - 1], PYRAMID[r], g))
        for r in range(rows - 1):
            for col in range(half, COLUMNS):
                setattr(self, f"up{r}{col}",
                        up_block(PYRAMID[r + 1], PYRAMID[r], g))
        self.output = nn.Sequential(_prelu(PYRAMID[0]),
                                    _conv(PYRAMID[0], 3, g))

    def _lateral(self, r, col, x):
        return x + getattr(self, f"lateral{r}{col}")(x)

    def forward(self, levels: list) -> torch.Tensor:
        rows, half = len(PYRAMID), COLUMNS // 2
        node = [None] * rows
        for col in range(half):
            for r in range(rows):
                x = (getattr(self, f"input{r}")(levels[r]) if col == 0
                     else self._lateral(r, col, node[r]))
                if r > 0:
                    x = x + getattr(self, f"down{r}{col}")(node[r - 1])
                node[r] = x
        for col in range(half, COLUMNS):
            for r in reversed(range(rows)):
                x = self._lateral(r, col, node[r])
                if r < rows - 1:
                    x = x + getattr(self, f"up{r}{col}")(node[r + 1])
                node[r] = x
        return self.output(node[0])


def resize(x: torch.Tensor, level: int) -> torch.Tensor:
    """``x`` bilinearly downsampled by 2^level (``align_corners=False``)."""
    if level == 0:
        return x
    h, w = x.shape[2] >> level, x.shape[3] >> level
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class SoftSplat(nn.Module):
    # the only time step it interpolates at (``ModelConfig`` checks it)
    TIME_STEP = TIMESTEP

    def __init__(self, generator: torch.Generator | None = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        if lane_dtype(compute_dtype) != torch.float32:
            raise ValueError("SoftSplat runs in float32 only")
        g = generator
        self.flownets = PWCDCNet(generator=g)
        self.extractor = Extractor(g)
        # each row's input: both directions' level (the first with the frame)
        inputs = [2 * (c + (3 if k == 0 else 0))
                  for k, c in enumerate(PYRAMID)]
        self.synthesis = GridNet(inputs, g)
        self.alpha = nn.Parameter(torch.full((1,), ALPHA))

    def forward(self, i0: torch.Tensor, i2: torch.Tensor) -> dict:
        """i0, i2: (B,3,H,W) frames, H and W multiples of 64.  Returns
        ``{"outputs": [frame]}``, frame (B,3,H,W)."""
        b, t = i0.shape[0], self.TIME_STEP
        with span("vfidkr/forward"):
            with span("vfidkr/flow") as s:
                raw_fwd, raw_bwd = self.flownets.bidirectional(i0, i2)
                s.outputs(raw_fwd, raw_bwd)
            with span("vfidkr/upsample") as s:
                # (2B,2,H,W): F0->1 of the B pairs, then F1->0
                flows = upsample_bilinear(torch.cat([raw_fwd, raw_bwd], 0)
                                          * DIV_FLOW, 4)
                s.outputs(flows)
            with span("vfidkr/softsplat/metric") as s:
                frames = torch.cat([i0, i2], 0)
                other = torch.cat([i2, i0], 0)
                z = (self.alpha * (frames - backwarp(other, flows)).abs()
                     .mean(1, keepdim=True)).clamp(-Z_CLIP, Z_CLIP)
                s.outputs(z)
            with span("vfidkr/softsplat/pyramid") as s:
                feats = self.extractor(frames)
                s.outputs(*feats)
            with span("vfidkr/softsplat/splat") as s:
                # t F0->1 and (1 - t) F1->0: one factor at t = 0.5
                moved = flows * t
                levels = []
                for k, feat in enumerate(feats):
                    x = torch.cat([frames, feat], 1) if k == 0 else feat
                    warped = softmax_splat(x, resize(moved, k) / 2 ** k,
                                           resize(z, k))
                    levels.append(torch.cat([warped[:b], warped[b:]], 1))
                s.outputs(*levels)
            with span("vfidkr/softsplat/synthesis") as s:
                out = self.synthesis(levels)
                s.outputs(out)
        return {"outputs": [out]}
