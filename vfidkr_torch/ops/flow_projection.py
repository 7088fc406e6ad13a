"""Flow projection with inference hole fill, NCHW.

Counterpart of ``flow_project(flow, hole_fill=True)`` in
``vfidkr_tpu/ops/flow_projection.py`` (reference CUDA op
``flowprojection_cuda_kernel.cu``: forward :29-93, average :95-137, fill
:141-234).  Per source pixel ``(y, x)`` with flow ``(fx, fy)``: land at
``x2 = x + fx``, ``y2 = y + fy``; if ``0 <= x2 <= W-1`` and
``0 <= y2 <= H-1``, add ``(-fx, -fy, 1)`` to the four neighbours
``(floor(y2) | min(floor(y2)+1, H-1), floor(x2) | min(floor(x2)+1, W-1))``.
At the right and bottom border the same cell gets two adds, as in the
reference.  Each cell with a count then takes the mean; a hole takes the mean
of the nearest filled cells to its left, right, top and bottom.

Two CUDA kernels carry it on the card:

* ``scatter4``: the scatter into (N,3,H,W) sums, channel 2 the count
  (``flow_project_scatter``, ``vfidkr_torch/csrc/flow_project_scatter.cu``);
* ``finalize``: the count average and hole fill
  (``flow_project_finalize``, ``vfidkr_torch/csrc/flow_project_finalize.cu``).

Each launches its kernel on CUDA tensors and runs its plain version on CPU
tensors.  The kernel's atomic adds make the summed flow depend on their order
to the last bits; the count is exact in any order.
"""

from __future__ import annotations

import torch

from vfidkr_torch import kernels


def _check_flow(flow):
    if flow.dim() != 4 or flow.shape[1] != 2 or flow.numel() == 0:
        raise ValueError(f"flow must be (N,2,H,W), got {tuple(flow.shape)}")


def _check_acc(acc):
    if acc.dim() != 4 or acc.shape[1] != 3 or acc.numel() == 0:
        raise ValueError(f"acc must be (N,3,H,W), got {tuple(acc.shape)}")


def scatter4_plain(flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the scatter: four ``index_add_`` passes."""
    _check_flow(flow)
    n, _, h, w = flow.shape
    dev = flow.device
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = torch.arange(w, dtype=torch.float32, device=dev) + fx
    y2 = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1) + fy
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    ix_l = torch.floor(x2).clamp(0, w - 1).long()
    iy_t = torch.floor(y2).clamp(0, h - 1).long()
    ix_r = (ix_l + 1).clamp(max=w - 1)
    iy_b = (iy_t + 1).clamp(max=h - 1)

    vals = torch.stack([torch.where(valid, -fx, 0.0),
                        torch.where(valid, -fy, 0.0),
                        valid.float()]).reshape(3, n * h * w)
    base = (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1)
    acc = torch.zeros(3, n * h * w, dtype=torch.float32, device=dev)
    for iy, ix in ((iy_t, ix_l), (iy_t, ix_r), (iy_b, ix_l), (iy_b, ix_r)):
        acc.index_add_(1, (base + iy * w + ix).reshape(-1), vals)
    return acc.reshape(3, n, h, w).permute(1, 0, 2, 3).contiguous()


def scatter4(flow: torch.Tensor) -> torch.Tensor:
    """(N,2,H,W) flow -> (N,3,H,W): summed (-fx, -fy) and the hit count."""
    _check_flow(flow)
    if flow.device.type == "cpu":
        return scatter4_plain(flow)
    kernels.check_inputs("flow_project_scatter", flow)
    n, _, h, w = flow.shape
    acc = torch.zeros((n, 3, h, w), dtype=torch.float32, device=flow.device)
    kernels.launch("flow_project_scatter", flow, acc, n, h, w)
    return acc


def _nearest_filled(out, filled, dim):
    """For each cell, the value of the nearest filled cell at or before it
    along ``dim`` of (N,H,W), and whether there is one."""
    size = filled.shape[dim]
    shape = [1, 1, 1]
    shape[dim] = size
    pos = torch.arange(size, device=filled.device).view(shape)
    last = torch.where(filled, pos, -1).cummax(dim).values
    idx = last.clamp(min=0).unsqueeze(1).expand_as(out)
    return out.gather(dim + 1, idx), last >= 0


def fill_holes(count: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Fill the cells with ``count <= 0`` with the mean of the nearest
    filled cell to the left, right, top and bottom (summed in that order);
    filled cells, and holes with no filled cell in any direction, pass
    through.  count (N,H,W), out (N,2,H,W) -> (N,2,H,W)."""
    filled = count > 0
    found = []
    for dim in (2, 1):                 # along rows (left, right), columns
        found.append(_nearest_filled(out, filled, dim))
        v, e = _nearest_filled(out.flip(dim + 1), filled.flip(dim), dim)
        found.append((v.flip(dim + 1), e.flip(dim)))
    num = torch.zeros_like(out)
    den = torch.zeros_like(count)
    for v, e in found:
        num = num + torch.where(e.unsqueeze(1), v, 0.0)
        den = den + e.float()
    filled_val = torch.where(den.unsqueeze(1) > 0,
                             num / den.clamp(min=1).unsqueeze(1), out)
    return torch.where(filled.unsqueeze(1), out, filled_val)


def finalize_plain(acc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the count average and hole fill."""
    _check_acc(acc)
    cnt = acc[:, 2]
    out = torch.where(cnt.unsqueeze(1) > 0,
                      acc[:, :2] / cnt.clamp(min=1).unsqueeze(1), 0.0)
    return fill_holes(cnt, out)


def finalize(acc: torch.Tensor) -> torch.Tensor:
    """(N,3,H,W) scatter sums -> (N,2,H,W) averaged, hole-filled flow."""
    _check_acc(acc)
    if acc.device.type == "cpu":
        return finalize_plain(acc)
    kernels.check_inputs("flow_project_finalize", acc)
    n, _, h, w = acc.shape
    out = torch.empty((n, 2, h, w), dtype=torch.float32, device=acc.device)
    kernels.launch("flow_project_finalize", acc, out, n, h, w)
    return out


def flow_project(flow: torch.Tensor) -> torch.Tensor:
    """Project a (N,2,H,W) flow onto the target-time grid, with the
    inference hole fill: ``flow_project(flow, hole_fill=True)`` of the JAX
    package."""
    return finalize(scatter4(flow))
