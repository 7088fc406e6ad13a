"""Plain PyTorch SepConv, written as a function of a state dict.

"Video Frame Interpolation via Adaptive Separable Convolution" (Niklaus,
Mai and Liu, ICCV 2017, arXiv:1708.01692), at the widths of the first
author's public PyTorch version, github.com/sniklaus/sepconv-slomo,
``run.py``, class ``Network``: ``P`` maps its parameter names
(``netConv1.0.weight``, ..., ``netVertical1.7.bias``, the ``nn.Sequential``
indices of ``run.py``) to tensors; ``lane`` maps each of its 17 children to
the precision its convolutions take (``ops.PRECISIONS``).

* the encoder ``netConv1..5``: three 3x3 convs and ReLUs each (6->32->64
  ->128->256->512), each level on the 2x2 average pool of the one before;
* the decoder ``netDeconv5..2`` (three convs and ReLUs) each followed by
  ``netUpsample5..2`` (bilinear x2, ``align_corners=False``, conv, ReLU),
  the encoder's levels added as skips; ``x = d2 + c2``;
* four subnets ``netVertical1/2``, ``netHorizontal1/2``: conv 64->64,
  ReLU, conv 64->64, ReLU, conv 64->51, ReLU, bilinear x2, conv 51->51;
* the output: each frame replication-padded by 25 px and convolved with its
  own separable 51x51 kernel at every pixel, the two summed.

``sepconv`` is the reference that the configuration names, with the
harness's signature ``(P, i0, i2, lane, config, training=False)``; it
returns ``([out],)``, the tuple that the workload's ``save_which`` (0)
indexes.  It is evaluation only (``training`` must be False).

Departures from ``run.py``, none of them in the arithmetic:
* ``run.py``'s ``estimate`` pads its input to a multiple of 32 itself;
  here the caller pads (the benchmark's copy of the video driver's
  padding, a multiple of 128).
* ``run.py``'s local convolution is a CUDA kernel written in CuPy
  (``sepconv.py``); here it runs a row of taps at a time
  (``local_conv``), so that a 1080p pair fits: per row ``j`` each pixel's
  51 values ``P[y + j, x .. x + 50]`` times its horizontal taps, a batched
  matrix product (which the FLOP count sees), then times the vertical tap
  ``v[j]`` and summed over the rows.
* The weights are the caller's (random from a seed in the benchmark), not
  the published ``l1`` / ``lf`` checkpoints.

It imports nothing of the program.  Each group of children runs through
``nets._stage``, so the FLOP count splits its work into ``encoder``,
``decoder``, ``kernels`` and ``local_conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import nets, ops

FILTER_SIZE = 51
ENCODER = ("netConv1", "netConv2", "netConv3", "netConv4", "netConv5")
DECODER = (5, 4, 3, 2)
SUBNETS = ("netVertical1", "netVertical2", "netHorizontal1",
           "netHorizontal2")


def _conv(P, name, x, prec):
    return ops.conv2d(x, P[name + ".weight"], P[name + ".bias"], 1, 1, 1,
                      prec)


def basic(P, child, x, lane):
    """Conv, ReLU three times (``Sequential`` indices 0, 2, 4)."""
    for i in (0, 2, 4):
        x = F.relu(_conv(P, f"{child}.{i}", x, lane[child]))
    return x


def upsample(P, child, x, lane):
    """Bilinear x2, conv, ReLU (the conv at index 1)."""
    return F.relu(_conv(P, f"{child}.1", ops.upsample_bilinear(x, 2),
                        lane[child]))


def subnet(P, child, x, lane):
    """Conv, ReLU, conv, ReLU, conv to 51, ReLU, bilinear x2, conv (indices
    0, 2, 4, 7)."""
    for i in (0, 2, 4):
        x = F.relu(_conv(P, f"{child}.{i}", x, lane[child]))
    return _conv(P, f"{child}.7", ops.upsample_bilinear(x, 2), lane[child])


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
        d = upsample(P, f"netUpsample{k}",
                     basic(P, f"netDeconv{k}", d, lane), lane)
    return d + c2


def kernels(P, x, lane):
    return [subnet(P, child, x, lane) for child in SUBNETS]


def local_conv(frame, v, h):
    """frame (N,C,H,W), v, h (N,fs,H,W) -> (N,C,H,W): ``sum_{j, i}
    pad(frame)[c, y + j, x + i] * v[j, y, x] * h[i, y, x]``, the frame
    replication-padded by fs // 2; a row of taps at a time."""
    hh, fs = frame.shape[2], v.shape[1]
    p = fs // 2
    padded = F.pad(frame, (p, p, p, p), mode="replicate")
    hcol = h.permute(0, 2, 3, 1).unsqueeze(-1)              # (N,H,W,fs,1)
    out = torch.zeros_like(frame)
    for j in range(fs):
        # (N,C,H,W,fs): the fs values right of each pixel in row y + j
        win = padded[:, :, j:j + hh, :].unfold(3, fs, 1)
        row = torch.matmul(win.permute(0, 2, 3, 1, 4), hcol)  # (N,H,W,C,1)
        out = out + row[..., 0].permute(0, 3, 1, 2) * v[:, j:j + 1]
    return out


def sepconv(P, i0, i2, lane, config, training=False):
    """(P, i0, i2, lane, config) -> ([out],): SepConv's middle frame of the
    (B,3,H,W) frames ``i0``, ``i2`` (sides multiples of 32)."""
    if training:
        raise ValueError("the SepConv reference is evaluation only")
    if config["filter_size"] != FILTER_SIZE:
        raise ValueError(f"filter_size {config['filter_size']}: the reference "
                         f"has run.py's {FILTER_SIZE}")
    levels = nets._stage("encoder", encoder, P, torch.cat([i0, i2], 1),
                         lane)
    x = nets._stage("decoder", decoder, P, levels, lane)
    v1, v2, h1, h2 = nets._stage("kernels", kernels, P, x, lane)
    out = nets._stage("local_conv", lambda: local_conv(i0, v1, h1)
                      + local_conv(i2, v2, h2))
    return ([out],)
