"""Layer helpers with the JAX package's initialisations, NCHW.

Counterpart of ``vfidkr_tpu/models/layers.py``: the three torch-matching
inits (:46-69), flax's default ``nn.Conv`` init (lecun normal, which
MegaDepth uses), ``leaky_relu``, ``upsample_bilinear``, the 2x2 pools and
the nearest upsample (:203-213, 289-292).  Convolutions are ``nn.Conv2d`` /
``nn.ConvTranspose2d`` themselves, created uninitialised and then filled
from a ``torch.Generator`` by the named init; biases start at 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init


# std of the unit normal truncated to [-2, 2], which flax divides out
_TRUNC_STD = 0.87962566103423978


def _fill(weight, init, fan_in, fan_out, generator):
    with torch.no_grad():
        if init == "kaiming":      # kaiming_normal_(mode="fan_in")
            weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        elif init == "xavier":     # xavier_uniform_
            a = math.sqrt(6.0 / (fan_in + fan_out))
            weight.uniform_(-a, a, generator=generator)
        elif init == "msra":       # normal(0, sqrt(2 / (k*k*out)))
            weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif init == "lecun":      # flax lecun_normal: truncated at 2 sigma
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")


def conv(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
         padding: int = 1, dilation: int = 1, bias: bool = True,
         init: str = "xavier",
         generator: torch.Generator | None = None) -> nn.Conv2d:
    """``nn.Conv2d`` with the named init and a zero bias."""
    m = skip_init(nn.Conv2d, cin, cout, kernel_size, stride=stride,
                  padding=padding, dilation=dilation, bias=bias)
    k2 = kernel_size * kernel_size
    _fill(m.weight, init, k2 * cin, k2 * cout, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def deconv(cin: int, cout: int,
           generator: torch.Generator | None = None) -> nn.ConvTranspose2d:
    """``nn.ConvTranspose2d(cin, cout, 4, 2, 1)`` (PWC-Net's upsampler) with
    the kaiming init, its fan counted as the JAX package counts it."""
    m = skip_init(nn.ConvTranspose2d, cin, cout, 4, stride=2, padding=1)
    _fill(m.weight, "kaiming", 16 * cin, 16 * cout, generator)
    nn.init.zeros_(m.bias)
    return m


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``nn.Upsample(scale_factor=factor, mode="bilinear",
    align_corners=False)``."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(2)``."""
    return F.max_pool2d(x, 2)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.AvgPool2d(2)``."""
    return F.avg_pool2d(x, 2)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``nn.UpsamplingNearest2d(scale_factor=factor)``."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")
