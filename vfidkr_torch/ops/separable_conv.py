"""SepConv-family ops, NCHW: counterpart of
``vfidkr_tpu/ops/separable_conv.py`` (the reference builds and tests the
first two; no DAIN model calls them), and SepConv's local convolution.

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

* ``separable_conv_pair`` (SepConv's output, ``models/sepconv.py``):
  ``separable_conv(pad(i0), v1, h1) + separable_conv(pad(i2), v2, h2)``,
  each frame replication-padded by ``fs // 2``, so the output has the
  frames' size.  On CUDA tensors it launches the kernel K9 ``sepconv_pair``
  (``vfidkr_torch/csrc/sepconv_pair.cu``: both frames and their sum in one
  launch, the frames read in place with clamped coordinates, true float32
  on the CUDA cores; three channels and 51 taps, SepConv's); on CPU tensors
  it runs ``separable_conv_pair_plain``.  K9 has no backward: on a CUDA
  input that needs a gradient it raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels

SENTINEL = -2000.0
K9_CHANNELS, K9_TAPS = 3, 51


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


def _check_pair(i0, v1, h1, i2, v2, h2) -> None:
    if i0.dim() != 4 or i0.numel() == 0 or tuple(i2.shape) != tuple(i0.shape):
        raise ValueError(f"i0 and i2 must be one non-empty (N,C,H,W) shape, "
                         f"got {tuple(i0.shape)} and {tuple(i2.shape)}")
    n, _, h, w = i0.shape
    fs = v1.shape[1] if v1.dim() == 4 else 0
    for name, f in (("v1", v1), ("h1", h1), ("v2", v2), ("h2", h2)):
        if tuple(f.shape) != (n, fs, h, w):
            raise ValueError(f"{name} must be (N, fs, H, W) = "
                             f"{(n, fs, h, w)}, got {tuple(f.shape)}")
    if fs % 2 == 0:
        raise ValueError(f"the filters need an odd number of taps, got {fs}")
    tensors = (i0, v1, h1, i2, v2, h2)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("separable_conv_pair: tensors on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("separable_conv_pair: float32 tensors only")


def separable_conv_pair_plain(i0, v1, h1, i2, v2, h2) -> torch.Tensor:
    """Plain PyTorch version: both frames through ``separable_conv`` after
    a replication pad of ``fs // 2``, then summed."""
    p = v1.shape[1] // 2
    pad = lambda x: F.pad(x, (p, p, p, p), mode="replicate")
    return separable_conv(pad(i0), v1, h1) + separable_conv(pad(i2), v2, h2)


def _launch(i0, v1, h1, i2, v2, h2) -> torch.Tensor:
    n, c, h, w = i0.shape
    fs = v1.shape[1]
    if c != K9_CHANNELS or fs != K9_TAPS:
        raise ValueError(f"sepconv_pair: K9 takes {K9_CHANNELS} channels and "
                         f"{K9_TAPS} taps, got {c} and {fs}")
    tensors = (i0, v1, h1, i2, v2, h2)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sepconv_pair: contiguous tensors only")
    out = torch.empty_like(i0)
    kernels.launch("sepconv_pair", *tensors, out, n, h, w)
    return out


def separable_conv_pair(i0: torch.Tensor, v1: torch.Tensor, h1: torch.Tensor,
                        i2: torch.Tensor, v2: torch.Tensor,
                        h2: torch.Tensor) -> torch.Tensor:
    """Frames i0, i2 (N,C,H,W) and their per-pixel filters v1, h1, v2, h2
    (N,fs,H,W), fs odd -> (N,C,H,W): ``out[c, y, x] = sum over both frames
    of sum_{j, i} P[c, y + j, x + i] * v[j, y, x] * h[i, y, x]``, ``P`` the
    frame replication-padded by ``fs // 2``.  K9 on CUDA tensors, the plain
    version on CPU tensors."""
    _check_pair(i0, v1, h1, i2, v2, h2)
    if i0.device.type == "cpu":
        return separable_conv_pair_plain(i0, v1, h1, i2, v2, h2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (i0, v1, h1, i2, v2, h2)):
        raise RuntimeError("sepconv_pair: K9 has no backward; the CUDA path "
                           "is evaluation only")
    return _launch(i0, v1, h1, i2, v2, h2)
