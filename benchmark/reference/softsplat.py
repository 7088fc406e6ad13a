"""Plain PyTorch SoftSplat, written as a function of a state dict.

"Softmax Splatting for Video Frame Interpolation" (Niklaus and Liu, CVPR
2020, arXiv:2003.05534), its operator as github.com/sniklaus/
softmax-splatting's ``softsplat.py`` gives it (the ``'soft'`` mode), its
synthesis network the GridNet of Fourure et al. (arXiv:1707.07958) at
CtxSyn's (arXiv:1803.10967) widths.  ``P`` maps the parameter names
(``flownets.conv1a.0.weight``, ``extractor.level1.0.weight``,
``synthesis.lateral01.1.weight``, ``alpha``) to tensors; ``lane`` maps
each child (``flownets``, ``extractor``, ``synthesis``) to the precision
its convolutions take (``ops.PRECISIONS``).

* flow: PWC-Net both ways (``nets.pwcnet_bidirectional``), x 20, bilinear
  x 4;
* the importance metric Z = alpha mean_c |I0 - backwarp(I1, F0->1)| (and
  swapped), clipped to [-20, 20]; backwarp samples bilinearly at exactly
  x + F, a tap outside the frame reading 0;
* the pyramid: per level conv, PReLU, conv, PReLU (3 -> 32, 32 -> 64 and
  64 -> 96, both with stride 2);
* the splat at levels 1-3 of cat(I, L1), L2, L3: each source pixel adds
  ``w e^Z x`` and ``w e^Z`` to the four cells around ``p + t F``, w the
  bilinear weight (1 - |qx - cx|)(1 - |qy - cy|), corners outside the frame
  and non-finite flows skipped; then the sum over the weight sum + 1e-7.
  The flow is bilinearly downsampled to the level and scaled by 2^-(k-1),
  Z downsampled and not scaled;
* GridNet: rows of 32, 64, 96 channels, 6 columns; inputs on both
  directions' levels at column 0; lateral (PReLU, conv, PReLU, conv + the
  input), down (PReLU, conv stride 2, PReLU, conv; columns 0-2) and up
  (bilinear x2, PReLU, conv, PReLU, conv; columns 3-5) paths summed at each
  node; PReLU and conv 32 -> 3 at row 0, column 5.

``softsplat`` is the reference that the configuration names, with the
harness's signature ``(P, i0, i2, lane, config, training=False)``; it
returns ``([out],)``, the tuple that the workload's ``save_which`` (0)
indexes.  It is evaluation only (``training`` must be False).

Departures from the paper, none of them in the arithmetic:
* the paper's refinement of Z by a small U-Net gives no widths, and is
  left out (the configuration's ``assumed``);
* the splat runs one level and one direction at a time, by ``index_add_``
  a corner at a time, where the public operator is a CUDA kernel of
  atomics (the sums in another order);
* the weights are the caller's (random from a seed in the benchmark): no
  trained SoftSplat is published.

It imports nothing of the program.  Each child runs through
``nets._stage``, so the FLOP count splits its work into ``flownets``,
``extractor`` and ``synthesis``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import nets, ops

DIV_FLOW = 20.0
Z_CLIP = 20.0
EPS = 1e-7
ROWS = (32, 64, 96)
COLUMNS = 6
# the four cells around a landing: (dx, dy) from its top-left one
CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _conv(P, name, x, prec, stride=1):
    return ops.conv2d(x, P[name + ".weight"], P[name + ".bias"], stride, 1, 1,
                      prec)


def _prelu(P, name, x):
    return F.prelu(x, P[name + ".weight"])


def backwarp(x, flow):
    """``x`` (N,C,H,W) sampled bilinearly at ``(i + fx, j + fy)``; a tap
    outside the frame reads 0."""
    n, c, h, w = x.shape
    gx = torch.arange(w, device=x.device, dtype=x.dtype).view(1, 1, w) \
        + flow[:, 0]
    gy = torch.arange(h, device=x.device, dtype=x.dtype).view(1, h, 1) \
        + flow[:, 1]
    left, top = gx.floor(), gy.floor()
    out = torch.zeros_like(x)
    for cy in (top, top + 1):
        for cx in (left, left + 1):
            wgt = (1 - (gx - cx).abs()) * (1 - (gy - cy).abs())
            ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            tap = x.flatten(2).gather(2, idx.flatten(1)[:, None].expand(
                n, c, h * w)).view(n, c, h, w)
            out = out + tap * (wgt * ok)[:, None]
    return out


def metric(P, i0, i1, flow):
    """Z of the frame ``i0`` that moves by ``flow`` towards ``i1``."""
    diff = (i0 - backwarp(i1, flow)).abs().mean(1, keepdim=True)
    return (P["alpha"] * diff).clamp(-Z_CLIP, Z_CLIP)


def splat(x, flow, z):
    """``x`` (1,C,H,W) splatted by ``flow`` with importance ``z``: the
    weighted sum over the weight sum, one corner at a time."""
    _, c, h, w = x.shape
    qx = torch.arange(w, device=x.device, dtype=x.dtype) + flow[0, 0]
    qy = torch.arange(h, device=x.device, dtype=x.dtype)[:, None] + flow[0, 1]
    ok = torch.isfinite(qx) & torch.isfinite(qy)
    qx, qy = qx[ok], qy[ok]
    e = torch.exp(z[0, 0][ok])
    src = torch.cat([x[0][:, ok] * e, e[None]], 0).t()      # (M, C + 1)
    total = torch.zeros(h * w, c + 1, device=x.device, dtype=x.dtype)
    for dx, dy in CORNERS:
        cx, cy = qx.floor() + dx, qy.floor() + dy
        wgt = (1 - (qx - cx).abs()) * (1 - (qy - cy).abs())
        inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        cell = (cy[inside] * w + cx[inside]).long()
        total.index_add_(0, cell, src[inside] * wgt[inside, None])
    total = total.t().reshape(1, c + 1, h, w)
    return normalise(total[:, :c], total[:, c:])


def normalise(num, den):
    """The splatted sum over the splatted weight sum."""
    return num / (den + EPS)


def pyramid(P, x, prec):
    feats = []
    for k in (1, 2, 3):
        name = f"extractor.level{k}"
        x = _prelu(P, f"{name}.1", _conv(P, f"{name}.0", x, prec,
                                         1 if k == 1 else 2))
        x = _prelu(P, f"{name}.3", _conv(P, f"{name}.2", x, prec))
        feats.append(x)
    return feats


def _block(P, name, x, prec, stride=1):
    """PReLU, conv (stride), PReLU, conv at indices 0-3."""
    x = _conv(P, f"{name}.1", _prelu(P, f"{name}.0", x), prec, stride)
    return _conv(P, f"{name}.3", _prelu(P, f"{name}.2", x), prec)


def gridnet(P, levels, prec):
    s = "synthesis."
    node = [None] * len(ROWS)
    for col in range(COLUMNS):
        order = range(len(ROWS)) if col < COLUMNS // 2 else \
            reversed(range(len(ROWS)))
        for r in order:
            if col == 0:
                name = f"{s}input{r}"
                x = _conv(P, f"{name}.2", _prelu(P, f"{name}.1", _conv(
                    P, f"{name}.0", levels[r], prec)), prec)
            else:
                x = node[r] + _block(P, f"{s}lateral{r}{col}", node[r], prec)
            if col < COLUMNS // 2 and r > 0:
                x = x + _block(P, f"{s}down{r}{col}", node[r - 1], prec, 2)
            if col >= COLUMNS // 2 and r < len(ROWS) - 1:
                up = ops.upsample_bilinear(node[r + 1], 2)
                x = x + _conv(P, f"{s}up{r}{col}.4", _prelu(
                    P, f"{s}up{r}{col}.3", _conv(
                        P, f"{s}up{r}{col}.2",
                        _prelu(P, f"{s}up{r}{col}.1", up), prec)), prec)
            node[r] = x
    return _conv(P, f"{s}output.1", _prelu(P, f"{s}output.0", node[0]), prec)


def _down(x, k):
    """``x`` bilinearly downsampled to level ``k`` (1 is full size)."""
    if k == 1:
        return x
    h, w = x.shape[2] // 2 ** (k - 1), x.shape[3] // 2 ** (k - 1)
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def softsplat(P, i0, i2, lane, config, training=False):
    """(P, i0, i2, lane, config) -> ([out],): SoftSplat's frame at t =
    ``config["time_step"]`` between the (B,3,H,W) frames ``i0``, ``i2``
    (sides multiples of 64)."""
    if training:
        raise ValueError("the SoftSplat reference is evaluation only")
    t = config["time_step"]
    fwd, bwd = nets._stage("flownets", nets.pwcnet_bidirectional, P, i0, i2,
                           lane["flownets"])
    f01 = ops.upsample_bilinear(fwd * DIV_FLOW, 4)
    f10 = ops.upsample_bilinear(bwd * DIV_FLOW, 4)
    sides = ((i0, i2, f01, t), (i2, i0, f10, 1.0 - t))
    levels = [[], [], []]
    for frame, other, flow, step in sides:
        z = metric(P, frame, other, flow)
        feats = nets._stage("extractor", pyramid, P, frame,
                            lane["extractor"])
        feats[0] = torch.cat([frame, feats[0]], 1)
        for k, feat in enumerate(feats, 1):
            f = _down(flow, k) * (step / 2 ** (k - 1))
            zk = _down(z, k)
            levels[k - 1].append(torch.cat(
                [splat(feat[i:i + 1], f[i:i + 1], zk[i:i + 1])
                 for i in range(feat.shape[0])], 0))
    out = nets._stage("synthesis", gridnet, P,
                      [torch.cat(pair, 1) for pair in levels],
                      lane["synthesis"])
    return ([out],)
