#!/usr/bin/env python3
"""Time K13 (``correlation``, PWC-Net's cost volume and its LeakyReLU,
forward and backward) on one NVIDIA GPU.

    python3 tools/bench_k13.py

First the card (chip_smoke.py's ``phase_device``: its name and power limit,
TF32 off) and the build's ptxas report for K13's kernels.  Then at every
PWC-Net level of cells 1 and 4, 5 and 8 (``tests/torch_corr.py``'s
LEVELS), of cell 2 (a 1344x768 pair) and of cells 3 and 6 (B = 3 at
256x448), forward and backward: the device time a launch by the profiler
(20 calls) and the time a call with CUDA events (median of 20 runs after a
warm-up; the host's where it is the slower), beside the bound (bytes at
3.35 TB/s or operations at 67 TFLOP/s, the larger) and beside the plain
float32 versions (the forward's chain of ops and autograd's backward of it,
by events).  K13's check against float64 is chip_smoke.py's phase 5r and
the card tests'.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import chip_smoke as cs  # noqa: E402
import torch_corr  # noqa: E402
from vfidkr_torch.kernels import build  # noqa: E402
from vfidkr_torch.ops import correlation as CV  # noqa: E402

# timed: torch_corr's levels, then cell 2 (a 1344x768 pair) and cells 3
# and 6 (B = 3 at 256x448, both directions)
TIMED = torch_corr.LEVELS + tuple(
    (f"{cell} L{lvl}", n, torch_corr.LEVEL_C[lvl], hh >> lvl, ww >> lvl)
    for cell, n, hh, ww in (("cell 2", 2, 768, 1344),
                            ("cells 3, 6", 6, 256, 448))
    for lvl in (2, 3, 4, 5, 6))
BW, F32 = 3.35e12, 67e12


def ms_per_call(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fwd(f1, f2):
    return CV._launch(f1, f2)


def bwd(f1, f2, out, g):
    return CV._launch_bwd(f1, f2, out, g, True, True)


def bounds_ms(n, c, h, w) -> tuple:
    px = n * h * w
    fwd_b = max((2 * c + CV.NCORR) * 4 * px / BW,
                2 * CV.NCORR * c * px / F32)
    bwd_b = max((2 * CV.NCORR + 4 * c) * 4 * px / BW,
                4 * CV.NCORR * c * px / F32)
    return fwd_b * 1e3, bwd_b * 1e3


def device_ms(fn, calls=20) -> float:
    """Device time a call of ``fn`` by the profiler: each of K13's kernels'
    time a launch, summed (a backward call runs two kernels); a session
    that drops some launches' events leaves the others' mean."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if "correlation" in e.key and e.count:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)) / e.count
    return total / 1e3


def time_level(label, f1, f2, g) -> None:
    n, c, h, w = f1.shape
    fb, bb = bounds_ms(n, c, h, w)
    out = fwd(f1, f2)
    tf = ms_per_call(lambda: fwd(f1, f2))
    tb = ms_per_call(lambda: bwd(f1, f2, out, g))
    df = device_ms(lambda: fwd(f1, f2))
    db = device_ms(lambda: bwd(f1, f2, out, g))
    print(f"[times] K13 {label} {(n, c, h, w)}: forward device {df:.4f} ms "
          f"(bound {fb:.4f}, {fb / df:.1%}), a call {tf:.4f}; backward device "
          f"{db:.4f} ms (bound {bb:.4f}, {bb / db:.1%}), a call {tb:.4f}",
          flush=True)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    tp = ms_per_call(lambda: CV.cost_volume_plain(f1, f2), iters=5)

    def plain_bwd():
        torch.autograd.grad(CV.cost_volume_plain(a1, a2), (a1, a2), g)
    tpb = ms_per_call(plain_bwd, iters=5) - tp
    print(f"[times] plain {label} {(n, c, h, w)}: forward {tp:.4f} ms, "
          f"backward (autograd's, forward subtracted) {tpb:.4f} ms",
          flush=True)


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    dev = cs.phase_device()
    build.load_library()
    for m in re.finditer(r"Compiling entry function '[^']*correlation[^']*'"
                         r".*?Used[^\n]*", build.BUILD_LOG, re.S):
        print("[build] " + " ".join(m.group(0).split()))
    for i, (label, n, c, h, w) in enumerate(TIMED):
        time_level(label, *torch_corr.inputs(n, c, h, w, i, dev))


if __name__ == "__main__":
    main()
