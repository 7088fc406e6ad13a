"""Plain PyTorch AdaCoF, written as a function of a state dict.

"AdaCoF: Adaptive Collaboration of Flows for Video Frame Interpolation"
(Lee, Kim, Chung, Pak, Ban and Lee, CVPR 2020, arXiv:1907.10244), at the
widths of the authors' public PyTorch version,
github.com/HyeongminLEE/AdaCoF-pytorch, ``models/adacofnet.py``
(``KernelEstimation``, ``AdaCoFNet``): ``P`` maps its parameter names
(``moduleConv1.0.weight``, ..., ``moduleOcclusion.7.bias``, the
``nn.Sequential`` indices of ``adacofnet.py``) to tensors; ``lane`` maps
each of its 20 children to the precision its convolutions take
(``ops.PRECISIONS``).  The configuration gives F (``kernel_size``), D
(``dilation``) and the input's per-channel mean (``input_mean``).

* the input: cat(I0 - mean, I2 - mean);
* the encoder ``moduleConv1..5``: three 3x3 convs and ReLUs each
  (6->32->64->128->256->512), each level on the 2x2 average pool of the one
  before (``sepconv.basic``: SepConv's blocks);
* the decoder ``moduleDeconv5..2`` (three convs and ReLUs) each followed by
  ``moduleUpsample5..2`` (bilinear x2, ``align_corners=True``, conv, ReLU),
  the encoder's levels added as skips; ``x = d2 + c2``;
* six heads: conv 64->64, ReLU, conv 64->64, ReLU, conv 64->F^2, ReLU,
  bilinear x2 (``align_corners=True``), conv F^2->F^2; ``moduleWeight1/2``
  then a softmax over the F^2 channels (W), ``moduleAlpha1/2`` the
  vertical and ``moduleBeta1/2`` the horizontal offsets; ``moduleOcclusion``
  three (conv, ReLU), bilinear x2, conv 64->1, sigmoid (V);
* the sampling: frame k replication-padded by D (F - 1) / 2; for tap (i, j)
  of pixel (y, x), the offset split at its floor, A = floor(alpha), a =
  alpha - A (B, b of beta); the corners at rows y + i D + A, + 1 and
  columns x + j D + B, + 1, each clamped to the padded frame, weighted
  (1 - a)(1 - b), (1 - a) b, a (1 - b), a b; T_k the sum over the F^2 taps
  of W times the sample; the output V T_0 + (1 - V) T_2.

``adacof`` is the reference that the configuration names, with the
harness's signature ``(P, i0, i2, lane, config, training=False)``; it
returns ``([out],)``, the tuple that the workload's ``save_which`` (0)
indexes.  It is evaluation only (``training`` must be False).  The caller
sets TF32 off (the benchmark's harness does); a conv whose lane says
``tf32`` turns it on for itself.

Departures from ``adacofnet.py`` and its CuPy kernel (the paper's
equations are kept):
* ``AdaCoFNet.forward`` pads its input to a multiple of 32 itself; here the
  caller pads (the benchmark's copy of the video driver's padding, a
  multiple of 128).
* The split of the offset.  The public CuPy kernel
  (``cupy_module/adacof.py``, ``kernel_AdaCoF_updateOutput``; not in this
  repository) takes ``int A = (int) alpha``, which truncates toward zero,
  and weights corners A and A + 1 by 1 - (alpha - A) and alpha - A: for a
  negative fractional offset it extrapolates from A and A + 1 where the
  paper's bilinear sample interpolates between A - 1 and A.  This
  reference follows the paper (the split at the floor, the same value as
  the sample at the clamped position), so it departs from the public
  arithmetic at every negative fraction, about half of the cell's taps
  (the configuration's ``assumed``).
* The sampling runs one tap at a time (F^2 gathers a frame, each of the
  four corners from the flattened padded frame), so that a 1080p pair
  fits, where the public kernel is a thread an output value.
* The weights are the caller's (random from a seed in the benchmark), not
  the published checkpoints; training's smoothness terms are left out.

It imports nothing of the program.  Each group of children runs through
``nets._stage``, so the FLOP count splits its work into ``encoder``,
``decoder``, ``kernels`` and ``sampling``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.sepconv import _conv, basic

ENCODER = ("moduleConv1", "moduleConv2", "moduleConv3", "moduleConv4",
           "moduleConv5")
DECODER = (5, 4, 3, 2)
HEADS = ("moduleWeight1", "moduleAlpha1", "moduleBeta1", "moduleWeight2",
         "moduleAlpha2", "moduleBeta2")
# (row, column) of each bilinear corner from the top-left one
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def up2(x):
    """Bilinear x2 with ``align_corners=True`` (AdaCoF's ``nn.Upsample``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def upsample(P, child, x, lane):
    """Bilinear x2, conv, ReLU (the conv at index 1)."""
    return F.relu(_conv(P, f"{child}.1", up2(x), lane[child]))


def encoder(P, x, lane):
    levels = []
    for k, child in enumerate(ENCODER):
        x = basic(P, child, x if k == 0 else F.avg_pool2d(x, 2), lane)
        levels.append(x)
    return levels


def decoder(P, levels, lane):
    c2, c3, c4, c5 = levels[1:]
    skips = {5: None, 4: c5, 3: c4, 2: c3}
    d = F.avg_pool2d(c5, 2)
    for k in DECODER:
        if skips[k] is not None:
            d = d + skips[k]
        d = upsample(P, f"moduleUpsample{k}",
                     basic(P, f"moduleDeconv{k}", d, lane), lane)
    return d + c2


def head(P, child, x, lane):
    """Conv, ReLU, conv, ReLU, conv to F^2, ReLU, bilinear x2, conv
    (indices 0, 2, 4, 7); the weights' heads end in a softmax."""
    for i in (0, 2, 4):
        x = F.relu(_conv(P, f"{child}.{i}", x, lane[child]))
    x = _conv(P, f"{child}.7", up2(x), lane[child])
    return torch.softmax(x, 1) if child.startswith("moduleWeight") else x


def occlusion(P, x, lane):
    child = "moduleOcclusion"
    for i in (0, 2, 4):
        x = F.relu(_conv(P, f"{child}.{i}", x, lane[child]))
    return torch.sigmoid(_conv(P, f"{child}.7", up2(x), lane[child]))


def kernels(P, x, lane):
    return [head(P, child, x, lane) for child in HEADS] + \
        [occlusion(P, x, lane)]


def floor(x):
    return torch.floor(x)


def sample(frame, weight, alpha, beta, dilation):
    """frame (N,C,H,W), weight, alpha, beta (N,F^2,H,W) -> (N,C,H,W): the
    weighted sum of each pixel's F^2 bilinear samples of the padded frame,
    a tap at a time."""
    n, c, h, w = frame.shape
    size = math.isqrt(weight.shape[1])
    pad = dilation * (size - 1) // 2
    hp, wp = h + 2 * pad, w + 2 * pad
    flat = F.pad(frame, (pad, pad, pad, pad), mode="replicate").flatten(2)
    rows = torch.arange(h, device=frame.device).view(h, 1)
    cols = torch.arange(w, device=frame.device).view(1, w)
    out = torch.zeros_like(frame)
    for tap in range(size * size):
        i, j = tap // size, tap % size
        va, vb = alpha[:, tap], beta[:, tap]
        ia, ib = floor(va), floor(vb)
        fa, fb = va - ia, vb - ib
        top = rows + i * dilation + ia.long()
        left = cols + j * dilation + ib.long()
        value = torch.zeros_like(frame)
        for dr, dc in CORNERS:
            r = (top + dr).clamp(0, hp - 1)
            q = (left + dc).clamp(0, wp - 1)
            idx = (r * wp + q).flatten(1).unsqueeze(1).expand(n, c, h * w)
            corner = flat.gather(2, idx).view(n, c, h, w)
            wr = fa if dr else 1 - fa
            wc = fb if dc else 1 - fb
            value = value + (wr * wc).unsqueeze(1) * corner
        out = out + weight[:, tap:tap + 1] * value
    return out


def sampling(i0, i2, heads, dilation):
    w0, a0, b0, w2, a2, b2, occ = heads
    return (occ * sample(i0, w0, a0, b0, dilation)
            + (1 - occ) * sample(i2, w2, a2, b2, dilation))


def adacof(P, i0, i2, lane, config, training=False):
    """(P, i0, i2, lane, config) -> ([out],): AdaCoF's middle frame of the
    (B,3,H,W) frames ``i0``, ``i2`` (sides multiples of 32)."""
    if training:
        raise ValueError("the AdaCoF reference is evaluation only")
    mean = torch.tensor(config["input_mean"], dtype=i0.dtype,
                        device=i0.device).view(1, 3, 1, 1)
    x = torch.cat([i0 - mean, i2 - mean], 1)
    levels = nets._stage("encoder", encoder, P, x, lane)
    x = nets._stage("decoder", decoder, P, levels, lane)
    heads = nets._stage("kernels", kernels, P, x, lane)
    out = nets._stage("sampling", sampling, i0, i2, heads,
                      config["dilation"])
    taps = heads[0].shape[1]
    if taps != config["kernel_size"] ** 2:
        raise ValueError(f"{taps} weights a pixel: the configuration's "
                         f"kernel_size is {config['kernel_size']}")
    return ([out],)
