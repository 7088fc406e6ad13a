"""SepConv-family ops, NCHW: counterpart of
``vfidkr_tpu/ops/separable_conv.py`` (the reference builds and tests them;
no model calls them).

* ``separable_conv``
  (``my_package/SeparableConv/separableconv_cuda_kernel.cu:40-80``):
  ``out[c, y, x] = sum_{j, i} in[c, y + j, x + i] * vert[j, y, x] *
  horiz[i, y, x]`` on the valid grid only: the filters and the output are
  (H - fs + 1, W - fs + 1).
* ``separable_conv_flow``
  (``my_package/SeparableConvFlow/separableconvflow_cuda_kernel.cu:40-92``):
  each 1-D filter's expected tap less the centre, ``sum_j j * k[j] /
  sum_j k[j] - (fs - 1) / 2``, as the flow (fx from ``horiz``, fy from
  ``vert``), and the sentinel -2000 where the filter sums to exactly 0.

Both are plain PyTorch on every device, not a fallback: the JAX package
computes them with static slices, not a Pallas kernel.
"""

from __future__ import annotations

import torch

SENTINEL = -2000.0


def _check_filters(vert, horiz):
    if vert.dim() != 4 or tuple(vert.shape) != tuple(horiz.shape):
        raise ValueError(f"vert and horiz must be one (N,fs,Ho,Wo) shape, "
                         f"got {tuple(vert.shape)} and {tuple(horiz.shape)}")


def separable_conv(image: torch.Tensor, vert: torch.Tensor,
                   horiz: torch.Tensor) -> torch.Tensor:
    """image (N,C,H,W); vert, horiz (N,fs,H-fs+1,W-fs+1) -> (N,C,H-fs+1,
    W-fs+1), each row of taps summed and then the rows, as JAX's."""
    _check_filters(vert, horiz)
    n, c, h, w = image.shape
    fs = vert.shape[1]
    ho, wo = h - fs + 1, w - fs + 1
    if tuple(vert.shape) != (n, fs, ho, wo):
        raise ValueError(f"filters must be {(n, fs, ho, wo)} for an image "
                         f"{tuple(image.shape)}, got {tuple(vert.shape)}")
    out = image.new_zeros(n, c, ho, wo)
    for j in range(fs):
        row = image.new_zeros(n, c, ho, wo)
        for i in range(fs):
            row = row + image[:, :, j:j + ho, i:i + wo] * horiz[:, i:i + 1]
        out = out + row * vert[:, j:j + 1]
    return out


def separable_conv_flow(vert: torch.Tensor,
                        horiz: torch.Tensor) -> torch.Tensor:
    """vert, horiz (N,fs,Ho,Wo) -> flow (N,2,Ho,Wo), channels (fx, fy)."""
    _check_filters(vert, horiz)
    fs = vert.shape[1]
    taps = torch.arange(fs, dtype=vert.dtype, device=vert.device).view(
        1, fs, 1, 1)

    def expected(k):
        s = k.sum(1)
        val = (k * taps).sum(1) / torch.where(s == 0, 1.0, s) - (fs - 1) / 2
        return torch.where(s.abs() > 0, val, SENTINEL)

    return torch.stack([expected(horiz), expected(vert)], 1)
