"""Layer helpers with the JAX package's initialisations, NCHW.

Counterpart of ``vfidkr_tpu/models/layers.py``: the three torch-matching
inits (:46-69), flax's default ``nn.Conv`` init (lecun normal, which
MegaDepth uses), ``leaky_relu``, ``upsample_bilinear``, the 2x2 pools, the
align-corners upsample of the vestigial OccNet, the nearest upsample and
the replication pad (:203-213, 265-298).  Convolutions are ``Conv2d``
(below) and ``nn.ConvTranspose2d``, created uninitialised and then filled
from a ``torch.Generator`` by the named init; biases start at 0.

The bf16 eval lane (``conv_compute_dtype`` of the JAX package, :20-43 and
:120-146) is a construction argument, ``compute_dtype``, not a context: a
``Conv2d`` made with ``torch.bfloat16`` casts its input and weight to bf16,
convolves (bf16 out, float32 sums) and then adds the bias cast to bf16, in
bf16, as the JAX ``Conv`` does.  Parameters stay float32, so one
state_dict serves both lanes.  ``torch.autocast`` is not used: its rules
are not the JAX package's, and it would reach PWC-Net and MegaDepth, which
stay float32 in the lane.
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


def lane_dtype(compute_dtype: str | torch.dtype) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (or the torch dtype) -> torch dtype."""
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) \
        else compute_dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype!r}")
    return dt


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (see the module doc);
    float32 is ``nn.Conv2d`` itself."""

    compute_dtype = torch.float32      # set per instance by ``conv``

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(-1, 1, 1)
        return y


def conv(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
         padding: int = 1, dilation: int = 1, bias: bool = True,
         init: str = "xavier", generator: torch.Generator | None = None,
         compute_dtype: torch.dtype = torch.float32) -> Conv2d:
    """``Conv2d`` with the named init and a zero bias."""
    m = skip_init(Conv2d, cin, cout, kernel_size, stride=stride,
                  padding=padding, dilation=dilation, bias=bias)
    m.compute_dtype = compute_dtype
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


def upsample_bilinear_align_corners(x: torch.Tensor,
                                    factor: int) -> torch.Tensor:
    """``nn.Upsample(scale_factor=factor, mode="bilinear",
    align_corners=True)``, the vestigial OccNet's upsample."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=True)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``nn.UpsamplingNearest2d(scale_factor=factor)``."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def replication_pad(x: torch.Tensor,
                    pads: tuple[int, int, int, int]) -> torch.Tensor:
    """``nn.ReplicationPad2d((left, right, top, bottom))``."""
    return F.pad(x, pads, mode="replicate")
