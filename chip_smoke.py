#!/usr/bin/env python3
"""Drive the PyTorch port's two paths, the DAIN eval forward and the DAIN
train step, on one NVIDIA GPU through its hand-written CUDA kernels, and
check them.

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
   the paths' shapes (2 x 256 x 448), with the tolerance stated; the
   backward kernels against the autograd of the plain forwards;
4. slice: DAIN eval at full width from seeded random weights, frames
   (1,3,256,448) on the 8-bit grid; each forward kernel's counter must rise
   by exactly 1 in one forward; the outputs are held to the same model run
   on the CPU, where every op takes its plain version;
5. times: CUDA events, DAIN ms/frame (median of 50 after 10 warm-up
   forwards) and each kernel's time beside its plain version's;
6. train: DAIN().train() at full width, B=3 triplets of 256x448 made in
   memory; 5 train steps, each launching the forward kernels and the
   backward kernels once and the hole fill never, with a finite loss and
   every Adamax group moved; one eval step (hole fill, no backward kernel);
   one train step's gradients held to the same step on the CPU, per leaf;
   the train step's time (median of 20 after 5 warm-up) and peak memory;
7. profile: where the train step's time goes: each stage's forward and
   backward timed alone, the Adamax step, torch.profiler over whole steps
   (device busy share, the largest device kernels), and the backward
   kernels' device time per launch;
8. one JSON line of the kernels, with each kernel's launches in one eval
   forward and one train step, then the result line.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.kernels import build
from vfidkr_torch.models import DAIN
from vfidkr_torch.models.dain import DIV_FLOW, TIMESTEP
from vfidkr_torch.models.layers import upsample_bilinear
from vfidkr_torch.ops import filter_interpolation as FI
from vfidkr_torch.ops import flow_projection as FP
from vfidkr_torch.training import (TrainConfig, eval_step, make_optimizer,
                                   train_step)
from vfidkr_torch.training.train_state import GROUPS

N, H, W = 2, 256, 448           # both directions of one 448x256 frame pair
ATOL = 1e-5                     # kernel vs plain, see _compare
TRAIN_B = 3                     # the reference's training batch
TRAIN_STEPS = 5
CPU_B = 1                       # batch of the GPU-against-CPU train step

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
    "filter_interpolate_bwd": (
        "vfidkr_torch/csrc/filter_interpolate_bwd.cu",
        "vfidkr_tpu/ops/pallas/filter_bandmm_bwd_kernel.py:144"),
    "flow_project_scatter_bwd": (
        "vfidkr_torch/csrc/flow_project_scatter_bwd.cu",
        "vfidkr_tpu/ops/pallas/projection_band_kernel.py:227"),
}
EVAL_KERNELS = ("filter_interpolate_fwd", "flow_project_scatter",
                "flow_project_finalize")
TRAIN_KERNELS = ("filter_interpolate_fwd", "flow_project_scatter",
                 "filter_interpolate_bwd", "flow_project_scatter_bwd")


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

    cot = torch.randn(N, 3, H, W, generator=g).to(dev)
    fi_k = _grads(FI.filter_interpolate, (image, flow, filt), cot)
    fi_p = _grads(FI.filter_interpolate_plain, (image, flow, filt), cot)
    err["filter_interpolate_bwd"] = max(
        _compare_grad(f"filter_interpolate_bwd grad->{name}", a, b)
        for name, a, b in zip(("image", "flow", "filt"), fi_k, fi_p))

    out_cot = torch.randn(N, 2, H, W, generator=g).to(dev)
    fp_k = _grads(lambda f: FP.flow_project(f, hole_fill=False), (flow,),
                  out_cot)
    fp_p = _grads(lambda f: FP._count_average(FP.scatter4_plain(f)),
                  (flow,), out_cot)
    err["flow_project_scatter_bwd"] = _compare_grad(
        "flow_project_scatter_bwd (flow_project(hole_fill=False) grad->flow)",
        fp_k[0], fp_p[0])
    torch.cuda.synchronize()
    inputs = {"filter_interpolate_fwd": (image, flow, filt),
              "flow_project_scatter": (flow,),
              "flow_project_finalize": (acc_k,),
              "filter_interpolate_bwd": ((image, flow, filt), cot),
              "flow_project_scatter_bwd": ((flow,), torch.randn(
                  N, 3, H, W, generator=g).to(dev))}
    return err, inputs


def _grads(fn, inputs, cot):
    """Gradients of ``fn`` w.r.t. every input under the cotangent ``cot``."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*ins), ins, cot)


def _compare_grad(name, got, want) -> float:
    """Max |got - want|; raises beyond ATOL * max(1, max |want|): the
    tolerance scales with the tensor's largest value, since the image
    gradient's atomic adds pile up at the frame's edge and sum in any
    order."""
    err = (got - want).abs().max().item()
    tol = ATOL * max(1.0, want.abs().max().item())
    print(f"[kernels] {name}: max |kernel - plain| = {err:.3e} "
          f"(tolerance {tol:.3e} = {ATOL:.0e} x max(1, max |plain|))")
    if not err <= tol:
        raise AssertionError(f"{name}: {err} exceeds {tol}")
    return err


def _check_launches(path, launches, expected) -> None:
    """Each kernel of ``expected`` launched exactly once, every other none."""
    for name in KERNELS:
        want = 1 if name in expected else 0
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"one {path}, expected {want}")


def make_model() -> torch.nn.Module:
    """DAIN at full width from seed 0, tamed; random weights predict almost
    no motion, so the flow head's bias is set to a (5.3, -3.1) px move and
    projection and warp shift pixels and leave holes at the frame's edges."""
    model = DAIN(generator=torch.Generator().manual_seed(0))
    tame(model)
    with torch.no_grad():
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.53, -0.31]))
    return model


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
    model = make_model().eval().to(dev)
    i0, i2 = make_frames(torch.Generator().manual_seed(1))
    i0d, i2d = i0.to(dev), i2.to(dev)

    with torch.inference_mode():
        kernels.reset_launches()
        out = model(i0d, i2d)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    print(f"[slice] launches in one DAIN eval forward: {launches}")
    _check_launches("eval forward", launches, EVAL_KERNELS)
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
    if kernels.LAUNCHES != launches:
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
    # a backward call: autograd.grad through the kernel's Function, against
    # the same through the plain forward's graph
    backward = {
        "filter_interpolate_bwd": (FI.filter_interpolate,
                                   FI.filter_interpolate_plain),
        "flow_project_scatter_bwd": (FP.scatter4, FP.scatter4_plain),
    }
    for name, (kernel_fn, plain_fn) in backward.items():
        ins, cot = inputs[name]
        ins = [t.detach().clone().requires_grad_() for t in ins]
        # the frames of the train path need no gradient: the image scatter
        # is skipped there, and timed so
        if name == "filter_interpolate_bwd":
            ins[0].requires_grad_(False)
        t = {}
        for kind, fn in (("plain", plain_fn), ("kernel", kernel_fn)):
            out = fn(*ins)
            leaves = [x for x in ins if x.requires_grad]
            t[kind] = statistics.median(cuda_times_ms(
                lambda: torch.autograd.grad(out, leaves, cot,
                                            retain_graph=True), inner=10))
        times[name] = (t["kernel"], t["plain"])
        print(f"[times] {name} at {tuple(ins[0].shape)}: kernel "
              f"{t['kernel'] * 1000:.1f} us, plain {t['plain'] * 1000:.1f} "
              f"us per backward call, autograd included (median of 50 x 10 "
              f"calls)")
    return times


def make_triplets(g: torch.Generator, b: int):
    """``b`` training triplets: a smooth random scene per sample, the
    middle frame its centre crop (the target), the first and last frames
    the crops moved by -(5, -3) and +(5, -3) px; all on the 8-bit grid."""
    scene = F.interpolate(torch.rand(b, 3, H // 16 + 1, W // 16 + 1,
                                     generator=g),
                          size=(H + 12, W + 12), mode="bicubic",
                          align_corners=False).clamp(0, 1)
    crop = lambda dx, dy: scene[:, :, 6 + dy:6 + dy + H, 6 + dx:6 + dx + W]
    q = lambda x: (torch.round(x * 255) / 255).contiguous()
    return {"x0": q(crop(-5, 3)), "x1": q(crop(5, -3)), "y": q(crop(0, 0))}


def phase_train(dev: torch.device):
    config = TrainConfig()
    model = make_model().to(dev)
    opt = make_optimizer(model, config)
    batch = {k: v.to(dev) for k, v in
             make_triplets(torch.Generator().manual_seed(2), TRAIN_B).items()}
    for step in range(TRAIN_STEPS):
        before = {name: [p.detach().clone() for p in grp["params"]]
                  for name, grp in zip(GROUPS, opt.param_groups)}
        kernels.reset_launches()
        m = train_step(model, opt, batch, config)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        _check_launches("train step", launches, TRAIN_KERNELS)
        total = float(m["total"])
        if not math.isfinite(total):
            raise AssertionError(f"train step {step}: loss {total}")
        moved = {}
        for name, grp in zip(GROUPS, opt.param_groups):
            live = [(p, b) for p, b in zip(grp["params"], before[name])
                    if p.grad.abs().max().item() > 1e-6]
            n_moved = sum(not torch.equal(p, b) for p, b in live)
            if not live or n_moved != len(live):
                raise AssertionError(f"train step {step}: {n_moved} of "
                                     f"{len(live)} {name} parameters with a "
                                     f"gradient moved")
            moved[name] = f"{n_moved}/{len(grp['params'])}"
        print(f"[train] step {step}: loss {total:.6f}, psnr "
              f"{float(m['psnr']):.3f} dB, launches {launches}, parameters "
              f"moved per group {moved}")

    kernels.reset_launches()
    m = eval_step(model, batch, config)
    torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)
    _check_launches("eval step", eval_launches, EVAL_KERNELS)
    if not math.isfinite(float(m["total"])):
        raise AssertionError(f"eval step: loss {float(m['total'])}")
    print(f"[train] eval step: loss {float(m['total']):.6f}, psnr "
          f"{float(m['psnr']):.3f} dB, launches {eval_launches}")
    return model, opt, batch, launches


def phase_train_vs_cpu(dev: torch.device) -> None:
    """One train step from the same weights and batch on both devices; the
    gradients per leaf within rtol 5e-3, atol 5e-3 x the leaf's largest
    magnitude (tests/test_full_graph_backward.py's tolerance)."""
    config = TrainConfig()
    cpu = make_model()
    gpu = copy.deepcopy(cpu).to(dev)
    batch = make_triplets(torch.Generator().manual_seed(3), CPU_B)
    got = train_step(gpu, make_optimizer(gpu, config),
                     {k: v.to(dev) for k, v in batch.items()}, config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = train_step(cpu, make_optimizer(cpu, config), batch, config)
    print(f"[train] GPU vs CPU at B={CPU_B} {H}x{W}: the CPU step took "
          f"{time.perf_counter() - t0:.1f} s; loss {float(got['total']):.7f} "
          f"(GPU) vs {float(want['total']):.7f} (CPU)")
    if not math.isclose(float(got["total"]), float(want["total"]),
                        rel_tol=1e-4):
        raise AssertionError("GPU and CPU train losses disagree")
    named = dict(cpu.named_parameters())
    failed = []
    for group, children in GROUPS.items():
        worst, n = (0.0, ""), 0
        for name, p in gpu.named_parameters():
            if not name.startswith(children):
                continue
            a, b = p.grad.cpu(), named[name].grad
            scale = max(a.abs().max().item(), b.abs().max().item(), 1e-12)
            worst = max(worst, ((a - b).abs().max().item() / scale, name))
            n += 1
            if not torch.allclose(a, b, rtol=5e-3, atol=5e-3 * scale):
                failed.append(name)
        print(f"[train] GPU vs CPU grads, group {group}: {n} leaves, worst "
              f"max|diff| / max|grad| {worst[0]:.3e} ({worst[1]}; rtol "
              f"5e-3, atol 5e-3 x max|grad|)")
    if failed:
        raise AssertionError(f"GPU and CPU gradients disagree: {failed}")


def phase_train_times(model, opt, batch) -> float:
    config = TrainConfig()
    torch.cuda.reset_peak_memory_stats()
    t = cuda_times_ms(lambda: train_step(model, opt, batch, config),
                      warmup=5, iters=20)
    ms = statistics.median(t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[times] DAIN train step B={TRAIN_B} {H}x{W} float32 TF32 off: "
          f"{ms:.3f} ms/step (median of {len(t)} after 5 warm-up; p80 "
          f"{t[int(0.8 * len(t)) - 1]:.3f} ms, min {t[0]:.3f}, max "
          f"{t[-1]:.3f}); peak memory {peak:.3f} GiB")
    return ms


def _stage_ms(model, fwd, inputs, need_grad) -> tuple[float, float]:
    """Median CUDA-event ms of ``fwd`` alone and of its backward (forward
    plus backward, less the forward), under a random cotangent."""
    ins = [t.detach().clone().requires_grad_(need_grad) for t in inputs]
    cot = torch.randn_like(fwd(*ins))
    t_f = statistics.median(cuda_times_ms(lambda: fwd(*ins), 3, 15))
    t_fb = statistics.median(cuda_times_ms(
        lambda: fwd(*ins).backward(cot), 3, 15))
    model.zero_grad(set_to_none=True)
    return t_f, t_fb - t_f


def _device_events(prof):
    """(start, end, name) in us of every device kernel and copy, sorted; the
    user annotations that the profiler also puts on the device timeline
    (``Optimizer.step#Adamax.step``) are left out."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def phase_train_profile(model, opt, batch, step_ms, inputs) -> None:
    """Where the train step's time goes: each stage's forward and backward
    on its own inputs, the Adamax step, whole steps under torch.profiler,
    and the backward kernels' device time at the kernel check's shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x0, x1 = batch["x0"], batch["x1"]
    b = x0.shape[0]
    model.train()

    def heads(frames):
        trunk = model.initScaleNets_filter(frames)
        return torch.cat([model.initScaleNets_filter1(trunk),
                          model.initScaleNets_filter2(trunk)], 1)

    def project(raw):
        return FP.flow_project(upsample_bilinear(raw * (DIV_FLOW * TIMESTEP),
                                                 4))

    def warp(offs, filt):
        refs = FI.filter_interpolate(torch.cat([x0, x1], 0), offs, filt)
        return torch.cat([refs[:b] / 2 + refs[b:] / 2, refs], 0)

    with torch.no_grad():      # each stage's inputs, from one forward
        f01 = heads(torch.cat([x0, x1], 1))
        filt = torch.cat([f01[:, :16], f01[:, 16:]], 0)
        raw = torch.cat(model.flownets.bidirectional(x0, x1), 0)
        offs = project(raw)
        cur_refs = warp(offs, filt)
        rect_in = torch.cat([cur_refs[:b], cur_refs[b:2 * b],
                             cur_refs[2 * b:], offs[:b], offs[b:], f01], 1)
    stages = [
        ("MonoNet5 + 2 heads", heads, [torch.cat([x0, x1], 1)], False),
        ("PWC-Net bidirectional", lambda a, c: torch.cat(
            model.flownets.bidirectional(a, c), 0), [x0, x1], False),
        ("upsample x4 + flow_project (K2, K6)", project, [raw], True),
        ("filter_interpolate (K1, K5) + blend", warp, [offs, filt], True),
        ("rectifier", model.rectifyNet, [rect_in], True),
    ]
    sum_f = sum_b = 0.0
    for name, fwd, ins, need_grad in stages:
        t_f, t_b = _stage_ms(model, fwd, ins, need_grad)
        sum_f, sum_b = sum_f + t_f, sum_b + t_b
        print(f"[profile] stage {name}: forward {t_f:.3f} ms, backward "
              f"{t_b:.3f} ms")
    config = TrainConfig()
    train_step(model, opt, batch, config)
    t_opt = statistics.median(cuda_times_ms(opt.step, 3, 15))
    n_tensors = sum(len(g["params"]) for g in opt.param_groups)
    print(f"[profile] stage Adamax step ({n_tensors} tensors): "
          f"{t_opt:.3f} ms")
    print(f"[profile] stage sums: forward {sum_f:.3f} ms, backward "
          f"{sum_b:.3f} ms, with Adamax {sum_f + sum_b + t_opt:.3f} ms; the "
          f"whole step {step_ms:.3f} ms")

    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_step(model, opt, batch, config)
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise AssertionError("torch.profiler recorded no device events")
    busy, run_s, run_e = 0.0, None, None
    for s0, e0, _ in events:          # union of the device intervals
        if run_e is None or s0 > run_e:
            busy += 0.0 if run_e is None else run_e - run_s
            run_s, run_e = s0, e0
        else:
            run_e = max(run_e, e0)
    busy += run_e - run_s
    span = events[-1][1] - events[0][0]
    print(f"[profile] {steps} train steps under torch.profiler: "
          f"{len(events) // steps} device events a step, busy "
          f"{busy / 1000 / steps:.3f} ms of a {span / 1000 / steps:.3f} ms "
          f"window a step: idle {1 - busy / span:.1%}")
    for name in TRAIN_KERNELS:
        ts = [e - s0 for s0, e, n in events if f"{name}_kernel" in n]
        print(f"[profile] {name} in the train step: {len(ts) // steps} "
              f"launches a step, {statistics.median(ts):.2f} us median device "
              f"time")
    names = {n for _, _, n in events}
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.key in names),
                 key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        ms = e.self_device_time_total / 1000 / steps
        print(f"[profile] top device kernel: {ms:8.3f} ms a step, "
              f"{e.count // steps:5d} launches a step, {e.key[:90]}")

    (image, flow, filt), cot = inputs["filter_interpolate_bwd"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for need_image in (True, False):
            ins = [image.clone().requires_grad_(need_image),
                   flow.clone().requires_grad_(), filt.clone().requires_grad_()]
            for _ in range(10):
                FI.filter_interpolate(*ins).backward(cot)
            torch.cuda.synchronize()
        f = flow.clone().requires_grad_()
        for _ in range(10):
            FP.scatter4(f).backward(inputs["flow_project_scatter_bwd"][1])
        torch.cuda.synchronize()
    events = _device_events(prof)
    k5 = [e - s0 for s0, e, n in events
          if "filter_interpolate_bwd_kernel" in n]
    k6 = [e - s0 for s0, e, n in events
          if "flow_project_scatter_bwd_kernel" in n]
    print(f"[profile] filter_interpolate_bwd at {tuple(image.shape)}: median "
          f"device time {statistics.median(k5[:10]):.2f} us with the image "
          f"gradient, {statistics.median(k5[10:]):.2f} us without")
    print(f"[profile] flow_project_scatter_bwd at {tuple(flow.shape)}: median "
          f"device time {statistics.median(k6):.2f} us")


def main() -> None:
    dev = phase_device()
    phase_build()
    err, inputs = phase_kernels(dev)
    model, i0, i2, launches = phase_slice(dev)
    times = phase_times(model, i0, i2, inputs)
    del model
    train_model, opt, batch, train_launches = phase_train(dev)
    phase_train_vs_cpu(dev)
    step_ms = phase_train_times(train_model, opt, batch)
    phase_train_profile(train_model, opt, batch, step_ms, inputs)
    per_path = {"eval_forward": launches, "train_step": train_launches}
    print(f"[launches] one eval forward: {launches}; one train step: "
          f"{train_launches}")
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name] + train_launches[name],
             "launches_per_path": {path: n[name]
                                   for path, n in per_path.items()},
             "max_abs_err": err[name],
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
