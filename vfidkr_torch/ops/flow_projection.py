"""Flow projection and depth-weighted flow projection, NCHW.

Counterpart of ``flow_project`` and ``depth_flow_project`` in
``vfidkr_tpu/ops/flow_projection.py`` (reference CUDA ops
``flowprojection_cuda_kernel.cu``: forward :29-93, average :95-137, fill
:141-234, backward :237-301; and ``depthflowprojection_cuda_kernel.cu``).
Per source pixel ``(y, x)`` with flow ``(fx, fy)`` and weight ``d`` (1, or
the inverse depth): land at ``x2 = x + fx``, ``y2 = y + fy``; if
``0 <= x2 <= W-1`` and ``0 <= y2 <= H-1``, add ``(-fx·d, -fy·d, d)`` to the
four neighbours ``(floor(y2) | min(floor(y2)+1, H-1), floor(x2) |
min(floor(x2)+1, W-1))``.  At the right and bottom border the same cell gets
two adds, as in the reference.  Each cell with a weight sum ``> 0`` then
takes the weighted mean.  In training the holes stay 0 and the gradient
flows back through the scatter; at inference a hole takes the mean of the
nearest filled cells to its left, right, top and bottom, and no gradient
reaches the flow (JAX's ``stop_gradient``).

Four CUDA kernels carry it on the card:

* ``scatter4``: the scatter into (N,3,H,W) sums, channel 2 the count or
  the weight sum (``flow_project_scatter``,
  ``vfidkr_torch/csrc/flow_project_scatter.cu``: a block per 8x32 tile of
  source pixels sums its adds in shared memory and flushes them once;
  ``scatter4_counted`` also returns how many tiles spread too far for that
  and added straight to the sums); unweighted, through an
  autograd Function whose backward is ``flow_project_scatter_bwd``
  (``vfidkr_torch/csrc/flow_project_scatter_bwd.cu``: a thread a source
  pixel gathers its four cells, on a 2D grid of 8x32 tiles);
* ``finalize``: the count average and hole fill, inference only
  (``flow_project_finalize``, ``vfidkr_torch/csrc/flow_project_finalize.cu``:
  a block per 32x32 tile, whose holes find their nearest filled cells over
  filled bitmasks, 32 cells a word);
* ``depth_flow_project_bwd`` (in ``flow_project_scatter_bwd.cu``): the
  backward of the depth-weighted projection, on the same grid, each of a
  pixel's four cells' ``g / cnt`` (and ``(g·out) / cnt``) formed with the
  plain version's roundings.

Each launches its kernel on CUDA tensors and runs its plain version on CPU
tensors.  The kernel's atomic adds make the summed flow depend on their order
to the last bits; a count is exact in any order, a weight sum is not.  The
training count average is plain PyTorch on both devices, as it is XLA in the
JAX package.

Inside a row-sharded frame (``vfidkr_torch.parallel.spatial``) the ops run
on one shard's halo-extended block and give the frame's own results there,
as JAX's ``_landing`` and sharded ``fill_holes`` do
(``vfidkr_tpu/ops/flow_projection.py:49-89,297-351``): the row bounds of a
landing are the frame's, a phantom source row (above or below the frame, in
the first or last shard's halo) adds nothing, and the hole fill searches up
and down over the shard's interior rows only, a column with no filled cell
there taking the nearest filled cell of the shards above (below), gathered
from every shard's first and last filled interior cell (``fill_summary``,
``fill_carries``).  The kernels take the block's place in the frame as
arguments (``row0, hg``; the interior rows and the carries), and so do the
plain versions.  Nothing takes a gradient inside a frame.

The depth-weighted projection's gradient is the reference's, not the
autodiff of its forward: its depth gradient has ``(f - out)`` where autodiff
gives ``(f + out)`` (``vfidkr_tpu/ops/flow_projection.py:545-581``).  So
``depth_flow_project`` is one autograd Function over the weighted scatter
and the average (and the hole fill, which takes no gradient), as JAX's
``custom_vjp`` covers ``_depth_flow_project_core``; its backward is
``depth_flow_project_bwd`` on the card and ``depth_flow_project_bwd_plain``
on the CPU.  The bare weighted ``scatter4`` records no gradient.
"""

from __future__ import annotations

import torch

from vfidkr_torch import kernels
from vfidkr_torch.parallel.spatial import (global_row_frame, no_grad_in_frame,
                                           row_frame)


def _check_flow(flow):
    if flow.dim() != 4 or flow.shape[1] != 2 or flow.numel() == 0:
        raise ValueError(f"flow must be (N,2,H,W), got {tuple(flow.shape)}")


def _check_acc(acc):
    if acc.dim() != 4 or acc.shape[1] != 3 or acc.numel() == 0:
        raise ValueError(f"acc must be (N,3,H,W), got {tuple(acc.shape)}")


def _check_weight(weight, flow):
    n, _, h, w = flow.shape
    if weight is not None and tuple(weight.shape) != (n, h, w):
        raise ValueError(f"weight must be {(n, h, w)}, got "
                         f"{tuple(weight.shape)}")


def _landing(flow, row0, hg):
    """Per pixel: fx, fy, valid and the clamped left, right, top and bottom
    target cells, for a block whose row 0 is the frame's row ``row0`` of
    ``hg``.  The landing row is the frame's, ``(y + row0) + fy``, rounded as
    the whole frame's is (JAX adds the block's row: the two can round apart
    by an ulp where a landing meets a row), so a sharded frame lands where
    the whole one does."""
    n, _, h, w = flow.shape
    dev = flow.device
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = torch.arange(w, dtype=torch.float32, device=dev) + fx
    yg = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1) + row0
    y2 = yg + fy
    valid = ((x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= hg - 1)
             & (yg >= 0) & (yg <= hg - 1))
    ix_l = torch.floor(x2).clamp(0, w - 1).long()
    # the frame's clamp, then the block's (which binds only for a flow that
    # reaches past the block)
    iy_t = (torch.floor(y2).clamp(0, hg - 1) - row0).clamp(0, h - 1).long()
    ix_r = (ix_l + 1).clamp(max=w - 1)
    iy_b = (iy_t + 1).clamp(max=min(hg - 1 - row0, h - 1))
    return fx, fy, valid, ix_l, ix_r, iy_t, iy_b


def scatter4_targets(flow: torch.Tensor, weight: torch.Tensor | None = None,
                     row0: int = 0, hg: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scatter's targets and values: (4, N·H·W) flat cell indices into
    (N·H·W) planes (top-left, top-right, bottom-left, bottom-right) and the
    (3, N·H·W) values each pixel adds at all four, 0 where it lands outside
    the frame.  ``row0, hg``: the block's place in a row-sharded frame
    (default: the whole frame)."""
    _check_flow(flow)
    _check_weight(weight, flow)
    n, _, h, w = flow.shape
    dev = flow.device
    fx, fy, valid, ix_l, ix_r, iy_t, iy_b = _landing(
        flow, row0, h if hg is None else hg)

    if weight is None:
        vals = torch.stack([torch.where(valid, -fx, 0.0),
                            torch.where(valid, -fy, 0.0), valid.float()])
    else:
        d = weight * valid.float()
        vals = torch.stack([-fx * d, -fy * d, d])
    base = (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1)
    idx = torch.stack([(base + iy * w + ix).reshape(-1) for iy, ix in
                       ((iy_t, ix_l), (iy_t, ix_r), (iy_b, ix_l), (iy_b, ix_r))])
    return idx, vals.reshape(3, n * h * w)


def scatter4_plain(flow: torch.Tensor, weight: torch.Tensor | None = None,
                   row0: int = 0, hg: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the scatter: four ``index_add_`` passes."""
    idx, vals = scatter4_targets(flow, weight, row0, hg)
    n, _, h, w = flow.shape
    acc = torch.zeros(3, n * h * w, dtype=torch.float32, device=flow.device)
    for target in idx:
        acc.index_add_(1, target, vals)
    return acc.reshape(3, n, h, w).permute(1, 0, 2, 3).contiguous()


def _launch_scatter4(flow, weight, direct_tiles=None):
    kernels.check_inputs("flow_project_scatter", flow,
                         *(() if weight is None else (weight,)))
    n, _, h, w = flow.shape
    acc = torch.zeros((n, 3, h, w), dtype=torch.float32, device=flow.device)
    kernels.launch("flow_project_scatter", flow, weight, acc, n, h, w,
                   *row_frame(h), direct_tiles)
    return acc


def scatter4_counted(flow: torch.Tensor, weight: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, int]:
    """``flow_project_scatter`` on CUDA tensors, forward only, with the
    number of 8x32 source tiles whose targets spread too far to sum in
    shared memory and took the kernel's direct adds instead."""
    _check_flow(flow)
    _check_weight(weight, flow)
    count = torch.zeros(1, dtype=torch.int32, device=flow.device)
    acc = _launch_scatter4(flow, weight, count)
    return acc, int(count.item())


class _Scatter4Kernel(torch.autograd.Function):
    """Forward ``flow_project_scatter`` unweighted, backward
    ``flow_project_scatter_bwd`` (the count channel carries no gradient to
    the flow)."""

    @staticmethod
    def forward(ctx, flow):
        ctx.save_for_backward(flow)
        return _launch_scatter4(flow, None)

    @staticmethod
    def backward(ctx, g):
        (flow,) = ctx.saved_tensors
        g = g.contiguous()
        kernels.check_inputs("flow_project_scatter_bwd", g, flow)
        n, _, h, w = flow.shape
        gflow = torch.empty_like(flow)
        kernels.launch("flow_project_scatter_bwd", flow, g, gflow, n, h, w)
        return gflow


def scatter4(flow: torch.Tensor,
             weight: torch.Tensor | None = None) -> torch.Tensor:
    """(N,2,H,W) flow -> (N,3,H,W): summed (-fx, -fy) and the hit count;
    with a (N,H,W) ``weight`` ``d``, summed (-fx·d, -fy·d) and the sum of
    ``d``.  The weighted scatter alone records no gradient, and raises where
    its inputs need one: the depth projection's gradient is
    ``depth_flow_project``'s, which covers the scatter and the average."""
    _check_flow(flow)
    _check_weight(weight, flow)
    if weight is not None and torch.is_grad_enabled() and (
            flow.requires_grad or weight.requires_grad):
        raise RuntimeError("the depth-weighted scatter has no backward of "
                           "its own: take the gradient through "
                           "depth_flow_project")
    no_grad_in_frame("scatter4", flow)
    if flow.device.type == "cpu":
        return scatter4_plain(flow, weight, *row_frame(flow.shape[2]))
    if weight is None:
        return _Scatter4Kernel.apply(flow)
    return _launch_scatter4(flow, weight)


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


def _carried(v, e, carry):
    """A search's (value, found) with ``carry`` (N,3,W) taken where nothing
    was found and the carry exists."""
    if carry is None:
        return v, e
    take = ~e & (carry[:, 2] > 0).unsqueeze(1)
    v = torch.where(take.unsqueeze(1), carry[:, :2].unsqueeze(2), v)
    return v, e | take


def fill_holes(count: torch.Tensor, out: torch.Tensor,
               interior: tuple[int, int] | None = None,
               carry_up: torch.Tensor | None = None,
               carry_down: torch.Tensor | None = None) -> torch.Tensor:
    """Fill the cells with ``count <= 0`` with the mean of the nearest
    filled cell to the left, right, top and bottom (summed in that order);
    filled cells, and holes with no filled cell in any direction, pass
    through.  count (N,H,W), out (N,2,H,W) -> (N,2,H,W).

    In a row-sharded frame the top and bottom searches cover the rows
    ``interior`` = [lo, hi) only, and a hole that finds none there takes
    ``carry_up`` / ``carry_down`` (N,3,W, see ``fill_carries``) where it
    exists."""
    filled = count > 0
    vertical = filled
    if interior is not None:
        rows = torch.arange(count.shape[1], device=count.device).view(-1, 1)
        vertical = filled & (rows >= interior[0]) & (rows < interior[1])
    found = [_nearest_filled(out, filled, 2)]              # left
    v, e = _nearest_filled(out.flip(3), filled.flip(2), 2)
    found.append((v.flip(3), e.flip(2)))                   # right
    found.append(_carried(*_nearest_filled(out, vertical, 1), carry_up))
    v, e = _nearest_filled(out.flip(2), vertical.flip(1), 1)
    found.append(_carried(v.flip(2), e.flip(1), carry_down))
    num = torch.zeros_like(out)
    den = torch.zeros_like(count)
    for v, e in found:
        num = num + torch.where(e.unsqueeze(1), v, 0.0)
        den = den + e.float()
    filled_val = torch.where(den.unsqueeze(1) > 0,
                             num / den.clamp(min=1).unsqueeze(1), out)
    return torch.where(filled.unsqueeze(1), out, filled_val)


def _count_average(acc):
    """(N,3,H,W) scatter sums -> (N,2,H,W) mean flow, 0 where no hit.  The
    clamp keeps the unselected quotients (and their gradients) finite; a
    count is 0 or at least 1, a weight sum 0 or at least 1e-6."""
    cnt = acc[:, 2:]
    return torch.where(cnt > 0, acc[:, :2] / cnt.clamp(min=1e-30), 0.0)


def fill_summary(acc: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """What a shard's hole fill tells the others: (N,2,3,W), for each column
    the mean of its last ([:, 0]) and first ([:, 1]) filled cell among rows
    [lo, hi) of the scatter sums ``acc``, and 1 where there is one (else 0
    and a mean of 0)."""
    n, _, _, w = acc.shape
    rows = hi - lo
    block = acc[:, :, lo:hi]
    filled = block[:, 2] > 0
    pos = torch.arange(rows, device=acc.device).view(1, rows, 1)
    last = torch.where(filled, pos, -1).amax(1)
    first = torch.where(filled, pos, rows).amin(1)
    parts = []
    for row, found in ((last, last >= 0), (first, first < rows)):
        idx = row.clamp(0, rows - 1).view(n, 1, 1, w).expand(n, 3, 1, w)
        cell = block.gather(2, idx).squeeze(2)               # (N,3,W)
        mean = cell[:, :2] / cell[:, 2:].clamp(min=1e-30)
        parts.append(torch.cat([torch.where(found.unsqueeze(1), mean, 0.0),
                                found.unsqueeze(1).float()], 1))
    return torch.stack(parts, 1)


def fill_carries(summaries: torch.Tensor, index: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard ``index``'s carries from every shard's ``fill_summary``
    (n,N,2,3,W): up, the last filled cell of the nearest shard above with
    one in the column; down, the first of the nearest shard below.  Each
    (N,3,W): mean x, mean y, and 1 where such a shard exists."""
    up = torch.zeros_like(summaries[0, :, 0])
    down = torch.zeros_like(up)
    for j in range(index):
        s = summaries[j, :, 0]
        up = torch.where(s[:, 2:] > 0, s, up)
    for j in range(summaries.shape[0] - 1, index, -1):
        s = summaries[j, :, 1]
        down = torch.where(s[:, 2:] > 0, s, down)
    return up, down


def _fill_frame(acc):
    """(interior rows, carry_up, carry_down) of the fill of ``acc`` inside a
    spatial frame, after gathering every shard's summary; (None, None,
    None) outside one."""
    frame = global_row_frame(acc.shape[2])
    if frame is None:
        return None, None, None
    _, _, axis, halo = frame
    interior = (halo, acc.shape[2] - halo)
    summaries = axis.all_gather(fill_summary(acc, *interior))
    return (interior, *fill_carries(summaries, axis.index))


def finalize_plain(acc: torch.Tensor, interior: tuple[int, int] | None = None,
                   carry_up: torch.Tensor | None = None,
                   carry_down: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the (weighted) average and hole fill."""
    _check_acc(acc)
    return fill_holes(acc[:, 2], _count_average(acc), interior, carry_up,
                      carry_down)


def finalize(acc: torch.Tensor) -> torch.Tensor:
    """(N,3,H,W) scatter sums -> (N,2,H,W) averaged, hole-filled flow.

    Inference only: the kernel has no backward, so on CUDA tensors it
    raises where ``acc`` needs a gradient.  Inside a spatial frame every
    shard must call it: the shards exchange their fill summaries."""
    _check_acc(acc)
    if acc.device.type != "cpu":
        if torch.is_grad_enabled() and acc.requires_grad:
            raise RuntimeError("flow_project_finalize has no backward: the "
                               "hole fill takes no gradient (detach its "
                               "input)")
        kernels.check_inputs("flow_project_finalize", acc)
    interior, up, down = _fill_frame(acc)
    if acc.device.type == "cpu":
        return finalize_plain(acc, interior, up, down)
    n, _, h, w = acc.shape
    lo, hi = (0, h) if interior is None else interior
    out = torch.empty((n, 2, h, w), dtype=torch.float32, device=acc.device)
    kernels.launch("flow_project_finalize", acc, out, n, h, w, lo, hi,
                   up, down)
    return out


def flow_project(flow: torch.Tensor, hole_fill: bool = False) -> torch.Tensor:
    """Project a (N,2,H,W) flow onto the target-time grid, as
    ``flow_project(flow, hole_fill)`` of the JAX package.

    ``hole_fill=False`` is the train projection: holes stay 0, and the
    gradient reaches the flow through the scatter.  ``hole_fill=True`` is the
    inference projection: holes are filled, and no gradient reaches the flow
    (the reference fills only when no gradient is wanted,
    ``FlowProjectionLayer.py:23``)."""
    if hole_fill:
        return finalize(scatter4(flow.detach()))
    return _count_average(scatter4(flow))


def depth_flow_project_bwd_plain(flow: torch.Tensor, depth: torch.Tensor,
                                 g: torch.Tensor, cnt: torch.Tensor,
                                 out: torch.Tensor, need_depth: bool = True):
    """Plain PyTorch version of the depth projection's backward (JAX's
    ``_dfp_bwd``): the field ``[g_x/cnt, g_y/cnt, (g·out)/cnt]`` summed over
    each source pixel's four cells (``tl, tr, bl, br``), then ``gflow =
    -(s0, s1)·d`` and ``gdepth = -(s0·fx + s1·fy - s2)``, 0 at an invalid
    pixel.  flow, g, out (N,2,H,W); depth, cnt (N,H,W).  Returns (gflow,
    gdepth or None)."""
    n, _, h, w = flow.shape
    fx, fy, valid, ix_l, ix_r, iy_t, iy_b = _landing(flow, 0, h)

    a = g / cnt.clamp(min=1e-30).unsqueeze(1)
    field = torch.cat([a, (a * out).sum(1, keepdim=True)], 1) if need_depth \
        else a
    c = field.shape[1]
    field = field.reshape(n, c, h * w)
    s = torch.zeros_like(field)
    for iy, ix in ((iy_t, ix_l), (iy_t, ix_r), (iy_b, ix_l), (iy_b, ix_r)):
        lin = (iy * w + ix).reshape(n, 1, h * w).expand(n, c, h * w)
        s = s + torch.gather(field, 2, lin)
    s = s.reshape(n, c, h, w)
    gflow = torch.where(valid.unsqueeze(1), -s[:, :2] * depth.unsqueeze(1),
                        0.0)
    if not need_depth:
        return gflow, None
    gdepth = torch.where(valid, -(s[:, 0] * fx + s[:, 1] * fy - s[:, 2]), 0.0)
    return gflow, gdepth


def depth_flow_project_bwd(flow: torch.Tensor, depth: torch.Tensor,
                           g: torch.Tensor, cnt: torch.Tensor,
                           out: torch.Tensor, need_depth: bool = True):
    """The depth projection's backward: kernel ``depth_flow_project_bwd`` on
    CUDA tensors (``gdepth`` NULL where ``need_depth`` is false), the plain
    version on CPU tensors.  Returns (gflow, gdepth or None)."""
    if flow.device.type == "cpu":
        return depth_flow_project_bwd_plain(flow, depth, g, cnt, out,
                                            need_depth)
    kernels.check_inputs("depth_flow_project_bwd", flow, depth, g, cnt, out)
    n, _, h, w = flow.shape
    for name, t, shape in (("depth", depth, (n, h, w)),
                           ("g", g, (n, 2, h, w)), ("cnt", cnt, (n, h, w)),
                           ("out", out, (n, 2, h, w))):
        if tuple(t.shape) != shape:
            raise ValueError(f"depth_flow_project_bwd: {name} must be "
                             f"{shape}, got {tuple(t.shape)}")
    gflow = torch.empty_like(flow)
    gdepth = torch.empty_like(depth) if need_depth else None
    kernels.launch("depth_flow_project_bwd", flow, depth, g, cnt, out, gflow,
                   gdepth, n, h, w)
    return gflow, gdepth


class _DepthFlowProject(torch.autograd.Function):
    """Forward: the weighted scatter (``flow_project_scatter``), the
    weighted average and, with ``hole_fill``, the fill
    (``flow_project_finalize``) of the detached sums.  Backward: the
    reference's (``depth_flow_project_bwd``), which ignores the fill."""

    @staticmethod
    def forward(ctx, flow, depth_inv, hole_fill):
        acc = scatter4(flow, depth_inv)
        need_grad = any(ctx.needs_input_grad[:2])
        out = _count_average(acc) if need_grad or not hole_fill else None
        if need_grad:
            ctx.save_for_backward(flow, depth_inv, acc[:, 2].contiguous(),
                                  out)
        return finalize(acc) if hole_fill else out

    @staticmethod
    def backward(ctx, g):
        flow, depth_inv, cnt, out = ctx.saved_tensors
        need_flow, need_depth, _ = ctx.needs_input_grad
        gflow, gdepth = depth_flow_project_bwd(flow, depth_inv, g.contiguous(),
                                               cnt, out, need_depth)
        return gflow if need_flow else None, gdepth, None


def depth_flow_project(flow: torch.Tensor, depth_inv: torch.Tensor,
                       hole_fill: bool = False) -> torch.Tensor:
    """Depth-weighted flow projection, as ``depth_flow_project(flow,
    depth_inv, hole_fill)`` of the JAX package: closer pixels (larger
    inverse depth) dominate each cell's average.

    flow (N,2,H,W), depth_inv (N,H,W) or (N,1,H,W), positive.  On CUDA
    tensors it launches ``flow_project_scatter`` with the weight and, with
    ``hole_fill``, ``flow_project_finalize``; its backward is the
    reference's (see the module docstring), in both modes: the hole fill
    takes no gradient, and the gradient is that of the unfilled average."""
    _check_flow(flow)
    n, _, h, w = flow.shape
    if depth_inv.dim() == 4:
        depth_inv = depth_inv.reshape(n, h, w)
    no_grad_in_frame("depth_flow_project", flow, depth_inv)
    return _DepthFlowProject.apply(flow, depth_inv.contiguous(), hole_fill)
