"""Plain PyTorch DAIN and DAIN_slowmotion, written as functions of a state
dict.

``P`` maps the reference checkpoint's parameter names (``flownets.conv1a.0.
weight``, ``rectifyNet.block1.0.weight``, ``depthNet.0.weight``, ...) to
tensors; ``lane`` maps each child (``initScaleNets_filter``,
``initScaleNets_filter1``, ``initScaleNets_filter2``, ``flownets``,
``rectifyNet``, ``ctxNet``, ``depthNet``) to the precision its convolutions
take (``ops.PRECISIONS``).  The networks follow the VFIDKR repository's
``networks/DAIN.py`` and ``networks/DAIN_slowmotion.py``:

* MonoNet5, a U-Net of 12 3x3 convs (6->16->...->512->...->16), and two
  heads of two 3x3 convs: the 4x4 kernels of each frame;
* PWC-Net (``PWCNet/PWCNet.py``): a 6-level pyramid, an 81-channel cost
  volume a level, DenseNet decoders, a dilated context net; flows at 1/4
  resolution, both directions;
* the flows scaled by ``20 t`` and upsampled x4; the projection onto time
  ``t`` (depth-weighted in slow motion); the filter interpolation of both
  frames (and of the 196-channel contexts in slow motion);
* the rectifier ``MultipleBasicBlock_4``: 7x7 conv, three residual blocks of
  128, 3x3 conv to 3 channels, added to the blend;
* in slow motion, the MegaDepth hourglass (``megadepth_spec.json``, a copy
  of the architecture file) and the S2DF context net.

``dain`` and ``dain_slowmotion`` are the references that configurations
name (``"reference": {"file": "nets.py", "function": ...}``), with the
reference's signature: ``(P, i0, i2, lane, config, training=False)`` ->
(blends, rectified), lists of one (B,3,H,W) frame a synthesised frame.
``GROUPS`` are the trained parameters of both.  A reference in a file of
its own names its children's stages through ``_stage``, so that the FLOP
count splits its work by child.

It imports nothing of the program.
"""

from __future__ import annotations

import json
import pathlib

import torch
import torch.nn.functional as F

from benchmark.reference import ops

DIV_FLOW = 20.0
MD = 4
_DENSE = (128, 128, 96, 64, 32)
_WARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_MONO = (0, 2, 5, 8, 11, 14, 17, 20, 23, 26, 29, 32)
_DC = ((1, 1), (2, 2), (3, 4), (4, 8), (5, 16), (6, 1))
# called as STAGE_HOOK(child name, function, args) around each child's
# call where set (the FLOP count splits the work by child this way)
STAGE_HOOK = None
SPEC = json.loads((pathlib.Path(__file__).parent /
                   "megadepth_spec.json").read_text())
# the trained parameters, as the VFIDKR repository's ``train.py`` groups
# them for Adamax: {group: (name prefixes, learning rate)}.  The vestigial
# children and DAIN_slowmotion's ctxNet and depthNet train in none.
GROUPS = {"filter": (("initScaleNets_filter.", "initScaleNets_filter1.",
                      "initScaleNets_filter2."), 2e-3),
          "flow": (("flownets.",), 2e-3 * 0.01),
          "rectify": (("rectifyNet.",), 1e-3)}


def _stage(name, fn, *args):
    return fn(*args) if STAGE_HOOK is None else STAGE_HOOK(name, fn, args)


def _conv(P, name, x, prec, stride=1, padding=1, dilation=1):
    return ops.conv2d(x, P[name + ".weight"], P.get(name + ".bias"), stride,
                      padding, dilation, prec)


def mononet(P, x, prec):
    """(B,6,H,W) -> (B,16,H,W)."""
    c = lambda i, h: F.relu(_conv(P, f"initScaleNets_filter.{i}", h, prec))
    h = c(_MONO[0], x)
    skips = []
    for i in _MONO[1:6]:
        h = c(i, h)
        skips.append(h)
        h = F.max_pool2d(h, 2)
    h = c(_MONO[6], h)
    for i in _MONO[7:]:
        h = ops.upsample_bilinear(h, 2) + skips.pop()
        h = c(i, h)
    return h


def branch(P, name, trunk, prec):
    h = F.relu(_conv(P, f"{name}.0", trunk, prec))
    return _conv(P, f"{name}.2", h, prec).float()


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _pyramid(P, im, prec):
    feats, x = [], im
    for lvl in range(1, 6):
        for s, stride in (("a", 2), ("aa", 1), ("b", 1)):
            x = _lrelu(_conv(P, f"flownets.conv{lvl}{s}.0", x, prec, stride))
        feats.append(x)
    for s, stride in (("aa", 2), ("a", 1), ("b", 1)):
        x = _lrelu(_conv(P, f"flownets.conv6{s}.0", x, prec, stride))
    feats.append(x)
    return feats


def _dense(P, lvl, x, prec):
    for i in range(len(_DENSE)):
        x = torch.cat([_lrelu(_conv(P, f"flownets.conv{lvl}_{i}.0", x, prec)),
                       x], 1)
    return x


def _deconv(P, name, x, prec):
    return ops.conv_transpose2d(x, P[name + ".weight"], P[name + ".bias"],
                                prec)


def pwcnet_bidirectional(P, im1, im2, prec):
    """Flows im1->im2 and im2->im1 at 1/4 size and 1/20 of the pixel flow."""
    b = im1.shape[0]
    pyr = _pyramid(P, torch.cat([im1, im2], 0), prec)
    other = [torch.cat([c[b:], c[:b]], 0) for c in pyr]
    corr = lambda a, c: _lrelu(ops.correlation(a, c, MD))
    x = _dense(P, 6, corr(pyr[5], other[5]), prec)
    flow = _conv(P, "flownets.predict_flow6", x, prec)
    for lvl in (5, 4, 3, 2):
        up_flow = _deconv(P, f"flownets.deconv{lvl + 1}", flow, prec)
        up_feat = _deconv(P, f"flownets.upfeat{lvl + 1}", x, prec)
        f1, f2 = pyr[lvl - 1], other[lvl - 1]
        warped = ops.pwc_warp(f2, up_flow * _WARP_SCALE[lvl])
        x = _dense(P, lvl, torch.cat([corr(f1, warped), f1, up_flow, up_feat],
                                     1), prec)
        flow = _conv(P, f"flownets.predict_flow{lvl}", x, prec)
    ctx = x
    for i, dil in _DC:
        ctx = _lrelu(_conv(P, f"flownets.dc_conv{i}.0", ctx, prec, 1, dil, dil))
    flow = flow + _conv(P, "flownets.dc_conv7", ctx, prec)
    return flow[:b], flow[b:]


def _resblock(P, name, x, prec, dilation=1):
    t = F.relu(_conv(P, f"{name}.conv1", x, prec, 1, dilation, dilation))
    return F.relu(_conv(P, f"{name}.conv2", t, prec) + x)


def rectifier(P, x, prec):
    """``MultipleBasicBlock_4`` -> (B,3,H,W) float32.  In the bf16 lane
    (and its fp8 control) the trunk takes the fused semantics."""
    h = F.relu(_conv(P, "rectifyNet.block1.0", x, prec, 1, 3))
    if prec in ("bfloat16", "fp8"):
        w6 = [P[f"rectifyNet.block{b}.conv{c}.weight"]
              for b in (2, 3, 4) for c in (1, 2)]
        h = ops.fused_trunk(h, w6, prec)
    else:
        for b in (2, 3, 4):
            h = _resblock(P, f"rectifyNet.block{b}", h, prec)
    return _conv(P, "rectifyNet.block5.0", h, prec).float()


def s2df(P, x, prec):
    """(B,3,H,W) -> (B,195,H,W): the input and each block's output."""
    f1 = F.relu(_conv(P, "ctxNet.block1.0", x, prec, 1, 3))
    f2 = _resblock(P, "ctxNet.block2", f1, prec, 4)
    f3 = _resblock(P, "ctxNet.block3", f2, prec, 8)
    return torch.cat([x, f1.float(), f2.float(), f3.float()], 1)


def _megadepth_node(P, node, path, x, prec):
    t = node["type"]
    kids = node.get("children", [])
    if t == "seq":
        for i, ch in enumerate(kids):
            x = _megadepth_node(P, ch, f"{path}.{i}", x, prec)
        return x
    if t in ("concat", "concat_table"):
        outs = [_megadepth_node(P, ch, f"{path}.{i}", x, prec)
                for i, ch in enumerate(kids)]
        return torch.cat(outs, 1) if t == "concat" else outs
    if t == "conv":
        return _conv(P, path, x, prec, node["s"][0], node["p"][0])
    if t == "bn":
        y = (x - P[path + ".running_mean"].view(1, -1, 1, 1)) * torch.rsqrt(
            P[path + ".running_var"].view(1, -1, 1, 1) + 1e-5)
        if node["affine"]:
            y = y * P[path + ".weight"].view(1, -1, 1, 1) + \
                P[path + ".bias"].view(1, -1, 1, 1)
        return y
    if t == "relu":
        return F.relu(x)
    if t == "maxpool":
        return F.max_pool2d(x, 2)
    if t == "avgpool":
        return F.avg_pool2d(x, 2)
    if t == "upnearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if t == "add":
        total = x[0]
        for y in x[1:]:
            total = total + y
        return total
    raise ValueError(f"unknown MegaDepth node {t}")


def megadepth(P, x, prec):
    """(B,3,H,W) -> (B,1,H,W) log-depth; BN on its running statistics."""
    return _megadepth_node(P, SPEC, "depthNet", x, prec)


def dain(P, i0, i2, lane, config, training=False):
    """DAIN at t = 0.5: ([blend], [rectified]).  In training the projection
    leaves its holes at 0 and the gradient reaches the flow through it."""
    b = i0.shape[0]
    trunk = _stage("initScaleNets_filter", mononet, P, torch.cat([i0, i2], 1),
                   lane["initScaleNets_filter"])
    filt0, filt1 = (_stage(n, branch, P, n, trunk, lane[n])
                    for n in ("initScaleNets_filter1", "initScaleNets_filter2"))
    fwd, bwd = _stage("flownets", pwcnet_bidirectional, P, i0, i2,
                      lane["flownets"])
    flows = ops.upsample_bilinear(torch.cat([fwd, bwd], 0) * (DIV_FLOW * 0.5), 4)
    offs = ops.flow_project(flows, hole_fill=not training)
    refs = ops.filter_interpolate(torch.cat([i0, i2], 0), offs,
                                  torch.cat([filt0, filt1], 0))
    ref0, ref2 = refs[:b], refs[b:]
    cur = ref0 / 2.0 + ref2 / 2.0
    x = torch.cat([cur, ref0, ref2, offs[:b], offs[b:], filt0, filt1], 1)
    rectified = _stage("rectifyNet", rectifier, P, x, lane["rectifyNet"]) + cur
    return [cur], [rectified]


def dain_slowmotion(P, i0, i2, lane, config, training=False):
    """DAIN_slowmotion at ``config["time_step"]``: ``1/timestep - 1``
    frames at t = timestep, 2 timestep, ...: (blends, rectified).

    The log-depth enters the contexts detached, and the contexts are
    warped with the offsets and kernels detached: no gradient reaches the
    frozen ctxNet and depthNet, nor the flow or the kernels through the
    contexts.  In training the depth-weighted projection leaves its holes
    at 0 and the gradient reaches the flow through it (the depth, from the
    frozen depthNet, takes none); MegaDepth's BN stays on its running
    statistics."""
    timestep = config["time_step"]
    b = i0.shape[0]
    frames = torch.cat([i0, i2], 0)
    log_depth = _stage("depthNet", megadepth, P, frames, lane["depthNet"])
    depth_inv = 1e-6 + torch.exp(-log_depth)
    ctx = torch.cat([_stage("ctxNet", s2df, P, frames, lane["ctxNet"]),
                     log_depth.detach()], 1)
    trunk = _stage("initScaleNets_filter", mononet, P, torch.cat([i0, i2], 1),
                   lane["initScaleNets_filter"])
    filt0, filt1 = (_stage(n, branch, P, n, trunk, lane[n])
                    for n in ("initScaleNets_filter1", "initScaleNets_filter2"))
    filt = torch.cat([filt0, filt1], 0)
    fwd, bwd = _stage("flownets", pwcnet_bidirectional, P, i0, i2,
                      lane["flownets"])
    n = int(round(1.0 / timestep)) - 1
    steps = [k * timestep for k in range(1, 1 + n)]
    blends, rectified = [], []
    for t, t_rev in zip(steps, steps[::-1]):
        flows = ops.upsample_bilinear(torch.cat(
            [fwd * (DIV_FLOW * t), bwd * (DIV_FLOW * t_rev)], 0), 4)
        offs = ops.depth_flow_project(flows, depth_inv,
                                      hole_fill=not training)
        ctx_w = ops.filter_interpolate(ctx, offs.detach(), filt.detach())
        refs = ops.filter_interpolate(frames, offs, filt)
        ref0, ref2 = refs[:b], refs[b:]
        out = ref0 * (1.0 - t) + ref2 * t
        x = torch.cat([out, ref0, ref2, offs[:b], offs[b:], filt0, filt1,
                       ctx_w[:b], ctx_w[b:]], 1)
        blends.append(out)
        rectified.append(_stage("rectifyNet", rectifier, P, x, lane["rectifyNet"]) + out)
    return blends, rectified
