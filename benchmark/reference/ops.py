"""Plain PyTorch ops of DAIN and DAIN_slowmotion, NCHW float32.

The benchmark's own copy of the plain arithmetic: PWC-Net's cost volume and
feature warp, the bilinear upsample, the flow projection (scatter to the
four cells of each landing, the count or depth-weighted average, the hole
fill from the nearest filled cells left, right, up and down), the 4x4
filter interpolation, the rectifier's fused residual trunk of the bf16
lane, and the convolution in each precision the configurations state or
that a control takes.  It imports nothing of the program.  Semantics follow
the reference CUDA ops of the VFIDKR repository (``my_package/``):
``FlowProjection``, ``DepthFlowProjection``, ``FilterInterpolation`` and
PWC-Net's ``Correlation`` and ``warp``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FILTER_SIZE = 4

# precision of a conv: what a configuration states, and the controls below it
PRECISIONS = ("float32", "bfloat16", "tf32", "fp8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away);
    the gradient passes straight through."""
    v = x.detach().float().contiguous()
    bits = (v.view(torch.int32) + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - v)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with a per-tensor scale (its largest
    magnitude maps to 448), back in ``x``'s dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


@contextlib.contextmanager
def tf32_on(device: torch.device):
    """cuDNN's and cuBLAS's TF32 on inside the context (CUDA only)."""
    if device.type != "cuda":
        yield
        return
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           precision="float32"):
    """A convolution in ``precision``: float32 as is; bfloat16 as the port's
    lane states it (bf16 operands and output, the bias added in bf16);
    tf32 with TF32 operands and float32 sums (cuDNN's TF32 on the card,
    rounded operands on the CPU); fp8, the bf16 conv on operands rounded
    through float8 e4m3."""
    if precision == "float32":
        return F.conv2d(x.float(), weight, bias, stride, padding, dilation)
    if precision == "tf32":
        if x.is_cuda:
            with tf32_on(x.device):
                return F.conv2d(x.float(), weight, bias, stride, padding,
                                dilation)
        return F.conv2d(round_tf32(x), round_tf32(weight), bias, stride,
                        padding, dilation)
    dt = torch.bfloat16
    xq, wq = x.to(dt), weight.to(dt)
    if precision == "fp8":
        xq, wq = round_fp8(xq), round_fp8(wq)
    elif precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    y = F.conv2d(xq, wq, None, stride, padding, dilation)
    return y if bias is None else y + bias.to(dt).view(-1, 1, 1)


def conv_transpose2d(x, weight, bias, precision="float32"):
    """PWC-Net's 4x4 stride-2 upsampling deconv, float32 (or TF32)."""
    if precision == "tf32" and not x.is_cuda:
        x, weight = round_tf32(x), round_tf32(weight)
    ctx = tf32_on(x.device) if precision == "tf32" else contextlib.nullcontext()
    with ctx:
        return F.conv_transpose2d(x, weight, bias, stride=2, padding=1)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False)


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(N,C,H,W) x (N,C,H,W) -> (N,(2md+1)^2,H,W): channel
    ``(tj+md)(2md+1) + (ti+md)`` is the channel mean of
    ``f1[y, x] * f2[y+tj, x+ti]``, ``f2`` zero-padded."""
    n, c, h, w = f1.shape
    d = 2 * md + 1
    f2p = F.pad(f2, (md, md, md, md))
    out = []
    for tj in range(d):
        for ti in range(d):
            out.append((f1 * f2p[:, :, tj:tj + h, ti:ti + w]).mean(1))
    return torch.stack(out, 1)


def pwc_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """PWC-Net's backward warp: grid normalised align-corners style but
    sampled with ``align_corners=False``, zero padding, masked where the
    sampled ones fall below 0.9999."""
    n, _, h, w = x.shape
    xx = torch.arange(w, dtype=torch.float32, device=x.device)
    yy = torch.arange(h, dtype=torch.float32, device=x.device).view(h, 1)
    gx = 2.0 * (xx + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (yy + flow[:, 1]) / max(h - 1, 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    mask = F.grid_sample(torch.ones_like(x[:, :1]), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)
    return out * (mask >= 0.9999).to(x.dtype)


def _landing(flow):
    """fx, fy, valid and the four clamped target cells of each pixel."""
    n, _, h, w = flow.shape
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = torch.arange(w, dtype=torch.float32, device=flow.device) + fx
    y2 = torch.arange(h, dtype=torch.float32, device=flow.device).view(h, 1) + fy
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    ix_l = torch.floor(x2).clamp(0, w - 1).long()
    iy_t = torch.floor(y2).clamp(0, h - 1).long()
    ix_r = (ix_l + 1).clamp(max=w - 1)
    iy_b = (iy_t + 1).clamp(max=h - 1)
    return fx, fy, valid, (ix_l, ix_r, iy_t, iy_b)


def scatter4(flow: torch.Tensor, weight: torch.Tensor | None = None):
    """(N,2,H,W) -> (N,3,H,W): ``(-fx d, -fy d, d)`` added at the four cells
    around each valid landing (``d`` 1, or the pixel's weight)."""
    n, _, h, w = flow.shape
    fx, fy, valid, (ix_l, ix_r, iy_t, iy_b) = _landing(flow)
    d = valid.float() if weight is None else weight * valid.float()
    if weight is None:
        vals = torch.stack([torch.where(valid, -fx, 0.0),
                            torch.where(valid, -fy, 0.0), d])
    else:
        vals = torch.stack([-fx * d, -fy * d, d])
    vals = vals.reshape(3, n * h * w)
    base = (torch.arange(n, device=flow.device) * (h * w)).view(n, 1, 1)
    acc = torch.zeros(3, n * h * w, dtype=torch.float32, device=flow.device)
    for iy, ix in ((iy_t, ix_l), (iy_t, ix_r), (iy_b, ix_l), (iy_b, ix_r)):
        acc = acc.index_add(1, (base + iy * w + ix).reshape(-1), vals)
    return acc.reshape(3, n, h, w).permute(1, 0, 2, 3)


def count_average(acc: torch.Tensor) -> torch.Tensor:
    cnt = acc[:, 2:]
    return torch.where(cnt > 0, acc[:, :2] / cnt.clamp(min=1e-30), 0.0)


def _nearest_filled(out, filled, dim):
    size = filled.shape[dim]
    shape = [1, 1, 1]
    shape[dim] = size
    pos = torch.arange(size, device=filled.device).view(shape)
    last = torch.where(filled, pos, -1).cummax(dim).values
    idx = last.clamp(min=0).unsqueeze(1).expand_as(out)
    return out.gather(dim + 1, idx), last >= 0


def fill_holes(count: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Cells with ``count <= 0`` take the mean of the nearest filled cell to
    the left, right, top and bottom that exists."""
    filled = count > 0
    found = [_nearest_filled(out, filled, 2)]
    v, e = _nearest_filled(out.flip(3), filled.flip(2), 2)
    found.append((v.flip(3), e.flip(2)))
    found.append(_nearest_filled(out, filled, 1))
    v, e = _nearest_filled(out.flip(2), filled.flip(1), 1)
    found.append((v.flip(2), e.flip(1)))
    num = torch.zeros_like(out)
    den = torch.zeros_like(count)
    for v, e in found:
        num = num + torch.where(e.unsqueeze(1), v, 0.0)
        den = den + e.float()
    filled_val = torch.where(den.unsqueeze(1) > 0,
                             num / den.clamp(min=1).unsqueeze(1), out)
    return torch.where(filled.unsqueeze(1), out, filled_val)


def flow_project(flow: torch.Tensor, hole_fill: bool) -> torch.Tensor:
    """The projection onto the middle frame: holes filled in evaluation
    (no gradient), left at 0 in training."""
    if hole_fill:
        acc = scatter4(flow.detach())
        return fill_holes(acc[:, 2], count_average(acc))
    return count_average(scatter4(flow))


def depth_flow_project(flow: torch.Tensor, depth_inv: torch.Tensor,
                       hole_fill: bool) -> torch.Tensor:
    """The depth-weighted projection: holes filled in evaluation (no
    gradient), left at 0 in training, where the gradient reaches the flow
    through the weighted scatter.  The depth takes no gradient: its net is
    frozen (the reference's depth gradient, which autodiff of this average
    would not give, is never asked for)."""
    n, _, h, w = flow.shape
    acc = scatter4(flow.detach() if hole_fill else flow,
                   depth_inv.detach().reshape(n, h, w))
    out = count_average(acc)
    return fill_holes(acc[:, 2], out) if hole_fill else out


def filter_interpolate(image: torch.Tensor, flow: torch.Tensor,
                       filt: torch.Tensor) -> torch.Tensor:
    """Warp ``image`` (N,C,H,W) by ``flow`` with the per-pixel 4x4 kernels
    ``filt`` (N,16,H,W): the window at ``(floor(y2)-1, floor(x2)-1)``, taps
    clamped to the frame, tap ``(dj, di)`` weighted ``filt * wy * wx``; an
    invalid landing (off the frame, or a move of half the frame or more)
    copies the source pixel."""
    n, c, h, w = image.shape
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = torch.arange(w, dtype=torch.float32, device=flow.device) + fx
    y2 = torch.arange(h, dtype=torch.float32, device=flow.device).view(h, 1) + fy
    valid = ((x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
             & (fx.abs() < w / 2) & (fy.abs() < h / 2))
    x2s, y2s = x2.clamp(0, w - 1), y2.clamp(0, h - 1)
    x0, y0 = torch.floor(x2s), torch.floor(y2s)
    alpha, beta = x2s - x0, y2s - y0
    ix, iy = x0.long(), y0.long()
    flat = image.reshape(n, c, h * w)
    out = torch.zeros_like(image)
    for dj in range(FILTER_SIZE):
        wy = beta if dj >= 2 else 1.0 - beta
        ty = (iy - 1 + dj).clamp(0, h - 1)
        for di in range(FILTER_SIZE):
            wx = alpha if di >= 2 else 1.0 - alpha
            tx = (ix - 1 + di).clamp(0, w - 1)
            lin = (ty * w + tx).reshape(n, 1, h * w).expand(n, c, h * w)
            tap = torch.gather(flat, 2, lin).reshape(n, c, h, w)
            out = out + (filt[:, dj * FILTER_SIZE + di] * wy * wx).unsqueeze(1) * tap
    return torch.where(valid.unsqueeze(1), out, image.detach())


def fused_trunk(x: torch.Tensor, w6, precision: str) -> torch.Tensor:
    """The bf16 lane's residual trunk, three blocks of two 3x3 convs, as
    the lane states it: bf16 operands, float32 sums, the residual added in
    float32 before the ReLU, each conv's output rounded to bf16 (fp8: the
    operands rounded through float8 first).  Returns bf16."""
    def q(t):
        t = t.to(torch.bfloat16)
        return (round_fp8(t) if precision == "fp8" else t).float()

    h = x.to(torch.bfloat16).float()
    for k in range(3):
        t = F.relu(F.conv2d(q(h), q(w6[2 * k]), padding=1)).to(
            torch.bfloat16).float()
        h = F.relu(F.conv2d(q(t), q(w6[2 * k + 1]), padding=1) + h).to(
            torch.bfloat16).float()
    return h.to(torch.bfloat16)
