"""MegaDepth single-image log-depth hourglass, NCHW.

Counterpart of ``MegaDepthHourglass._run`` / ``_run_inception`` in
``vfidkr_tpu/models/megadepth.py:128-278`` (reference
``MegaDepth/pytorch_DIW_scratch.py``), unfused and unpacked.  The
architecture is ``megadepth_spec.json`` (a copy of the JAX package's,
kept beside this module): 156 convs, 155 BNs, 22 concats, 4
ConcatTable/CAddTable pairs, 2 max pools, 2 average pools and 4 nearest
upsamples.  The spec tree is built as nested modules indexed as the spec's
children are, so the ``state_dict`` keys are the reference checkpoint's
``depthNet.<i>.<j>...`` paths, and the JAX package's ``n_<i>_<j>...``
names map onto them one to one.

BN is ``BatchNorm2d(ch, eps=1e-5, affine=...)`` on its running statistics;
batch statistics are not ported (JAX's ``train_bn`` is False in all its
apps), so ``DAINSlowMotion.train()`` keeps this module in eval mode.
Init: flax's ``nn.Conv`` default (lecun normal, zero bias); BN mean 0,
var 1, scale 1, bias 0.
"""

from __future__ import annotations

import json
import pathlib

import torch
from torch import nn

from vfidkr_torch.models.layers import (avg_pool_2x2, conv, max_pool_2x2,
                                        upsample_nearest)

SPEC = json.loads(
    (pathlib.Path(__file__).parent / "megadepth_spec.json").read_text())


class _Op(nn.Module):
    """A parameterless node of the spec."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _Concat(nn.ModuleList):
    """``nn.Concat(2)``: each child on the same input, concatenated along
    the channels."""

    def forward(self, x):
        return torch.cat([child(x) for child in self], 1)


class _ConcatTable(nn.ModuleList):
    """``nn.ConcatTable``: each child on the same input, as a list."""

    def forward(self, x):
        return [child(x) for child in self]


def _add(xs):
    """``nn.CAddTable``: the sum of the incoming list."""
    total = xs[0]
    for y in xs[1:]:
        total = total + y
    return total


_OPS = {"relu": torch.relu, "maxpool": max_pool_2x2, "avgpool": avg_pool_2x2,
        "upnearest": lambda x: upsample_nearest(x, 2), "add": _add}


def _build(node: dict, generator: torch.Generator | None = None) -> nn.Module:
    """The module of one spec node, its children built recursively."""
    t = node["type"]
    children = [_build(c, generator) for c in node.get("children", [])]
    if t == "seq":
        return nn.Sequential(*children)
    if t == "concat":
        return _Concat(children)
    if t == "concat_table":
        return _ConcatTable(children)
    if t == "conv":
        (kh, kw), (sh, _), (ph, _) = node["k"], node["s"], node["p"]
        assert kh == kw and node["s"] == [sh, sh] and node["p"] == [ph, ph]
        return conv(node["in"], node["out"], kh, sh, ph, init="lecun",
                    generator=generator)
    if t == "bn":
        return nn.BatchNorm2d(node["ch"], eps=1e-5, affine=node["affine"])
    if t in _OPS:
        return _Op(_OPS[t])
    raise ValueError(f"unknown spec node {t}")


class MegaDepthHourglass(nn.Sequential):
    """(B,3,H,W) RGB in [0, 1], H and W divisible by 16 -> (B,1,H,W)
    log-depth."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__(*_build(SPEC, generator))


def depth_inv_from_log_depth(log_depth: torch.Tensor) -> torch.Tensor:
    """``1e-6 + 1 / exp(log_depth)`` (DAIN_slowmotion.py:143)."""
    return 1e-6 + torch.exp(-log_depth)
