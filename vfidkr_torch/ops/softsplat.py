"""Softmax splatting, NCHW float32: the forward warp of "Softmax Splatting
for Video Frame Interpolation" (Niklaus and Liu, CVPR 2020,
arXiv:2003.05534; the operator ``softsplat.py`` of
github.com/sniklaus/softmax-splatting, its ``'soft'`` mode).

Each source pixel p of ``x`` (N,C,H,W) moves to q = p + flow(p) and lands
on the four cells around q with the bilinear weights w_c = (1 - |qx - cx|)
(1 - |qy - cy|), each weighted by exp(z(p)):

    out[c, cell] = sum_p w e^z x[c, p] / (sum_p w e^z + 1e-7)

A corner outside the frame is skipped (the others of the pixel still
land); a pixel whose flow is not finite lands nowhere.  A cell that no
pixel reaches reads 0.

On CUDA tensors ``softmax_splat`` launches the kernel K12
``softmax_splat`` (``vfidkr_torch/csrc/softmax_splat.cu``): a block sums an
8x32 tile's adds into a shared-memory box of the cells they land in, C + 1
channels (the weight sum last) in chunks, and flushes the box to a scratch
sum by atomics; a second kernel of the same entry point divides.  The
atomics add in any order, so two runs agree to the last bits of a sum, not
bit for bit.  On CPU tensors it runs ``softmax_splat_plain`` (``index_add_``
a corner at a time).  The model batches both directions of a level, so the
splat launches once a level.  K12 has no backward: a CUDA input that needs
a gradient raises.  It replaces no TPU kernel: the JAX package has no
forward splat of features.
"""

from __future__ import annotations

import torch

from vfidkr_torch import kernels

EPS = 1e-7          # the normalisation's guard, the operator's 0.0000001


def _check(x: torch.Tensor, flow: torch.Tensor, z: torch.Tensor) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N,C,H,W), got "
                         f"{tuple(x.shape)}")
    n, _, h, w = x.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"flow must be {(n, 2, h, w)}, got "
                         f"{tuple(flow.shape)}")
    if tuple(z.shape) != (n, 1, h, w):
        raise ValueError(f"z must be {(n, 1, h, w)}, got {tuple(z.shape)}")
    if len({t.device for t in (x, flow, z)}) != 1:
        raise ValueError("softmax_splat: tensors on different devices")
    if any(t.dtype != torch.float32 for t in (x, flow, z)):
        raise TypeError("softmax_splat: float32 tensors only")


def softmax_splat_plain(x: torch.Tensor, flow: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the weighted values ``x e^z`` and the weight
    ``e^z`` channels-last, added to each corner's cell by ``index_add_``
    (the top-left corner first), then divided."""
    n, c, h, w = x.shape
    ez = torch.exp(z)
    vals = torch.cat([x * ez, ez], 1).permute(0, 2, 3, 1).reshape(-1, c + 1)
    qx = torch.arange(w, dtype=x.dtype, device=x.device) + flow[:, 0]
    qy = torch.arange(h, dtype=x.dtype, device=x.device).view(h, 1) \
        + flow[:, 1]
    finite = torch.isfinite(qx) & torch.isfinite(qy)
    qx, qy = torch.where(finite, qx, 0.0), torch.where(finite, qy, 0.0)
    x0, y0 = torch.floor(qx), torch.floor(qy)
    ax, ay = qx - x0, qy - y0
    base = (torch.arange(n, device=x.device) * (h * w)).view(n, 1, 1)
    acc = x.new_zeros(n * h * w, c + 1)
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            cx, cy = x0 + dx, y0 + dy
            inside = finite & (cx >= 0) & (cx <= w - 1) & (cy >= 0) & \
                (cy <= h - 1)
            idx = (base + cy.clamp(0, h - 1).long() * w
                   + cx.clamp(0, w - 1).long()).reshape(-1)
            keep = inside.reshape(-1)
            acc.index_add_(0, idx[keep],
                           vals[keep] * (wx * wy).reshape(-1, 1)[keep])
    acc = acc.view(n, h, w, c + 1).permute(0, 3, 1, 2)
    return acc[:, :c] / (acc[:, c:] + EPS)


def _launch(x, flow, z, direct_tiles=None) -> torch.Tensor:
    kernels.check_inputs("softmax_splat", x, flow, z)
    n, c, h, w = x.shape
    acc = torch.empty((n, c + 1, h, w), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    kernels.launch("softmax_splat", x, flow, z, acc, out, n, c, h, w,
                   direct_tiles)
    return out


def softmax_splat(x: torch.Tensor, flow: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """x (N,C,H,W), flow (N,2,H,W) (fx, fy in pixels), z (N,1,H,W) ->
    (N,C,H,W): ``x`` forward-warped by ``flow`` with the importance ``z``
    (module docstring).  K12 on CUDA tensors, the plain version on CPU
    tensors."""
    _check(x, flow, z)
    if x.device.type == "cpu":
        return softmax_splat_plain(x, flow, z)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, flow, z)):
        raise RuntimeError("softmax_splat: K12 has no backward; the CUDA "
                           "path is evaluation only")
    return _launch(x, flow, z)


def softmax_splat_counted(x: torch.Tensor, flow: torch.Tensor,
                          z: torch.Tensor) -> tuple:
    """K12 on CUDA tensors, with the number of tiles that took its direct
    atomics (a box too large for shared memory): (out, tiles)."""
    _check(x, flow, z)
    tiles = torch.zeros(1, dtype=torch.int32, device=x.device)
    out = _launch(x, flow, z, tiles)
    return out, int(tiles.item())
