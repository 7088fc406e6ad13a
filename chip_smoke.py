#!/usr/bin/env python3
"""Drive the PyTorch port's main path (DAIN eval forward) once on one NVIDIA
GPU, through its hand-written CUDA kernels, and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script exits
non-zero and prints no result line:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit as nvidia-smi gives them; turns TF32 off for convolutions and
   matmuls, so the float32 path is held to float32 references;
2. build: compiles vfidkr_torch/csrc/*.cu with nvcc (into build/, on first
   use) and loads the library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (2 x 256 x 448), with the tolerance stated;
4. slice: DAIN at full width from seeded random weights, frames
   (1,3,256,448) on the 8-bit grid; every kernel launch counter must rise by
   exactly 1 in one forward; the outputs are held to the same model run on
   the CPU, where every op takes its plain version;
5. times: CUDA events, DAIN ms/frame (median of 50 after 10 warm-up
   forwards) and each kernel's time beside its plain version's;
6. one JSON line of the kernels, then the result line.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.kernels import build
from vfidkr_torch.models import DAIN
from vfidkr_torch.ops import filter_interpolation as FI
from vfidkr_torch.ops import flow_projection as FP

N, H, W = 2, 256, 448           # both directions of one 448x256 frame pair
ATOL = 1e-5                     # kernel vs plain, see _compare

KERNELS = {
    "filter_interpolate_fwd": (
        "vfidkr_torch/csrc/filter_interpolate.cu",
        "vfidkr_tpu/ops/pallas/filter_bandmm_kernel.py:126"),
    "flow_project_scatter": (
        "vfidkr_torch/csrc/flow_project_scatter.cu",
        "vfidkr_tpu/ops/pallas/projection_band_kernel.py:90"),
    "flow_project_finalize": (
        "vfidkr_torch/csrc/flow_project_finalize.cu",
        "vfidkr_tpu/ops/pallas/fillhole_kernel.py:90"),
}


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA "
                           "GPU and has no CPU fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print("[device] nvidia-smi name, power.limit:")
    print(smi.strip().splitlines()[0])
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"[device] TF32 defaults: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[device] TF32 set: cudnn.allow_tf32=False, "
          "cuda.matmul.allow_tf32=False")
    return torch.device("cuda:0")


def phase_build() -> None:
    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _compare(name, got, want) -> float:
    """Max |got - want|; raises beyond ATOL * max(1, |want|): ATOL absolute
    up to magnitude 1, relative above it, where one float32 ulp exceeds
    ATOL (|flow| reaches W/2 = 224 px in the border cases, ulp 1.5e-5)."""
    diff = (got - want).abs()
    err = diff.max().item()
    scaled = (diff / want.abs().clamp(min=1.0)).max().item()
    print(f"[kernels] {name}: max |kernel - plain| = {err:.3e}, scaled by "
          f"max(1, |plain|) = {scaled:.3e} (tolerance {ATOL:.0e})")
    if not scaled <= ATOL:
        raise AssertionError(f"{name}: {scaled} exceeds {ATOL}")
    return err


def make_flow(g: torch.Generator) -> torch.Tensor:
    """A smooth random flow up to +-24 px (slopes under 0.5, so the
    projection folds little), about 5% of pixels pushed out of the frame, and
    the exact-border cases of both kernels' bounds."""
    coarse = (torch.rand(N, 2, 3, 5, generator=g) * 2 - 1) * 24
    flow = F.interpolate(coarse, size=(H, W), mode="bilinear",
                         align_corners=True)
    out = torch.rand(N, H, W, generator=g) < 0.05
    side = torch.where(torch.rand(N, H, W, generator=g) < 0.5, -1.0, 1.0)
    flow[:, 0] = torch.where(out, flow[:, 0] + side * (W + 16), flow[:, 0])
    flow[0, :, 20:40, W - 8] = torch.tensor([7.0, 0.0])[:, None]   # x2 == W-1
    flow[0, :, H - 6, 100:140] = torch.tensor([0.0, 5.0])[:, None]  # y2 == H-1
    flow[1, :, 30:40, 0] = torch.tensor([W / 2, 0.0])[:, None]     # |fx| == W/2
    flow[1, :, 40:50, 0] = torch.tensor([W / 2 - 0.5, 0.0])[:, None]
    flow[1, :, 50:60, 10] = torch.tensor([0.0, H / 2])[:, None]    # |fy| == H/2
    return flow


def phase_kernels(dev: torch.device) -> tuple[dict, dict]:
    g = torch.Generator().manual_seed(0)
    flow = make_flow(g).to(dev)
    image = torch.rand(N, 3, H, W, generator=g).to(dev)
    filt = torch.randn(N, 16, H, W, generator=g).to(dev)
    err = {}

    err["filter_interpolate_fwd"] = _compare(
        "filter_interpolate_fwd", FI.filter_interpolate(image, flow, filt),
        FI.filter_interpolate_plain(image, flow, filt))

    acc_k = FP.scatter4(flow)
    acc_p = FP.scatter4_plain(flow)
    if not torch.equal(acc_k[:, 2], acc_p[:, 2]):
        raise AssertionError("flow_project_scatter: hit count differs")
    print(f"[kernels] flow_project_scatter: hit count equal "
          f"(total {acc_k[:, 2].sum().item():.0f}, max per cell "
          f"{acc_k[:, 2].max().item():.0f})")
    cnt = acc_p[:, 2:].clamp(min=1)
    err["flow_project_scatter"] = _compare(
        "flow_project_scatter (averaged flow; atomic order)",
        acc_k[:, :2] / cnt, acc_p[:, :2] / cnt)

    holes = (acc_k[:, 2] <= 0).float().mean().item()
    fin_k = FP.finalize(acc_k)
    err["flow_project_finalize"] = _compare(
        f"flow_project_finalize ({holes:.2%} holes)", fin_k,
        FP.finalize_plain(acc_k))
    _compare("flow_project, both kernels vs the plain chain", fin_k,
             FP.finalize_plain(acc_p))
    torch.cuda.synchronize()
    inputs = {"filter_interpolate_fwd": (image, flow, filt),
              "flow_project_scatter": (flow,),
              "flow_project_finalize": (acc_k,)}
    return err, inputs


def tame(model: torch.nn.Module, seed: int = 0) -> None:
    """Shrink the random weights so activations stay sane through the deep
    graph, and jitter the biases so the flows are not trivial (the policy
    of tests/test_full_graph_parity.py)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.mul_(0.5)
            if name.endswith("bias"):
                p.add_((torch.rand(p.shape, generator=g) - 0.5) * 0.02)


def make_frames(g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """A smooth random scene and the same scene moved by (5, -3) px, both on
    the 8-bit grid."""
    scene = F.interpolate(torch.rand(1, 3, H // 16 + 1, W // 16 + 1,
                                     generator=g),
                          size=(H + 10, W + 10), mode="bicubic",
                          align_corners=False).clamp(0, 1)
    i0 = scene[:, :, 5:5 + H, 5:5 + W]
    i2 = scene[:, :, 2:2 + H, 10:10 + W]
    q = lambda x: torch.round(x * 255) / 255
    return q(i0).contiguous(), q(i2).contiguous()


def _violations(got, want, rtol, atol):
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    return diff.max().item(), int(bad.sum().item())


def phase_slice(dev: torch.device):
    model = DAIN(generator=torch.Generator().manual_seed(0))
    tame(model)
    with torch.no_grad():
        # random weights predict almost no motion: bias the flow head to a
        # (5.3, -3.1) px move, so projection and warp shift pixels and
        # leave holes at the frame's edges
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.53, -0.31]))
    model = model.eval().to(dev)
    i0, i2 = make_frames(torch.Generator().manual_seed(1))
    i0d, i2d = i0.to(dev), i2.to(dev)

    with torch.inference_mode():
        kernels.reset_launches()
        out = model(i0d, i2d)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    print(f"[slice] launches in one DAIN forward: {launches}")
    for name in KERNELS:
        if launches[name] != 1:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"not once, in one forward")
    for key, pair in out.items():
        for t in pair:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"non-finite values in {key}")
    rect = out["outputs"][1]
    if tuple(rect.shape) != (1, 3, H, W):
        raise AssertionError(f"rectified shape {tuple(rect.shape)}")
    off_mag = out["offsets"][0].abs().max().item()
    print(f"[slice] outputs finite; rectified {tuple(rect.shape)}, "
          f"max |offset| {off_mag:.3f} px, mean rectified "
          f"{rect.mean().item():.4f}")

    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        ref = cpu_model(i0, i2)
    if any(launches[k] != kernels.LAUNCHES[k] for k in KERNELS):
        raise AssertionError("the CPU forward launched a kernel")
    checks = [("offsets[0]", out["offsets"][0], ref["offsets"][0], 1e-4),
              ("offsets[1]", out["offsets"][1], ref["offsets"][1], 1e-4),
              ("cur_output", out["outputs"][0], ref["outputs"][0], 2e-4),
              ("rectified", out["outputs"][1], ref["outputs"][1], 2e-4)]
    failed = []
    for name, got, want, atol in checks:
        worst, nbad = _violations(got.cpu(), want, 1e-3, atol)
        print(f"[slice] GPU vs CPU {name}: max |diff| {worst:.3e}, "
              f"{nbad} elements beyond rtol 1e-3 atol {atol:.0e}")
        if nbad:
            failed.append(name)
    if failed:
        raise AssertionError(f"GPU and CPU forwards disagree: {failed}")
    return model, i0d, i2d, launches


def cuda_times_ms(fn, warmup=10, iters=50, inner=1) -> list[float]:
    """Sorted CUDA-event times of ``iters`` runs of ``inner`` calls, per
    call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)


def phase_times(model, i0, i2, inputs) -> dict:
    with torch.inference_mode():
        t = cuda_times_ms(lambda: model(i0, i2))
    ms = statistics.median(t)
    print(f"[times] DAIN eval 448x256 B=1 float32 TF32 off: {ms:.3f} ms/frame, "
          f"{1000.0 / ms:.2f} frames/s (median of {len(t)} after 10 "
          f"warm-up; p80 {t[int(0.8 * len(t)) - 1]:.3f} ms, min {t[0]:.3f}, "
          f"max {t[-1]:.3f})")
    pairs = {
        "filter_interpolate_fwd": (FI.filter_interpolate,
                                   FI.filter_interpolate_plain),
        "flow_project_scatter": (FP.scatter4, FP.scatter4_plain),
        "flow_project_finalize": (FP.finalize, FP.finalize_plain),
    }
    times = {}
    with torch.inference_mode():
        for name, (kernel_fn, plain_fn) in pairs.items():
            args = inputs[name]
            t_plain = statistics.median(
                cuda_times_ms(lambda: plain_fn(*args), inner=10))
            t_kernel = statistics.median(
                cuda_times_ms(lambda: kernel_fn(*args), inner=10))
            times[name] = (t_kernel, t_plain)
            print(f"[times] {name} at {tuple(args[0].shape)}: kernel "
                  f"{t_kernel * 1000:.1f} us, plain {t_plain * 1000:.1f} us "
                  f"per call, wrapper included (median of 50 x 10 calls)")
    return times


def main() -> None:
    dev = phase_device()
    phase_build()
    err, inputs = phase_kernels(dev)
    model, i0, i2, launches = phase_slice(dev)
    times = phase_times(model, i0, i2, inputs)
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": err[name],
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
