#!/usr/bin/env python3
"""Check and time K8 (``rectify_head``, the float32 rectifier head) on one
NVIDIA GPU beside cuDNN.

    python3 tools/bench_k8.py [--check-only]

First the card (chip_smoke.py's ``phase_device``: its name and power limit,
TF32 off) and the build's ptxas report for the kernel (registers, spills).
Then chip_smoke.py's check (``_compare_k8``: against float64 and the plain
version, two launches bit for bit) at the cells' shapes and two ragged ones.
Unless ``--check-only``: one call's time at each of the cells' shapes with
CUDA events (median of 20 runs after a warm-up), beside the bound (the
operations at 67 TFLOP/s float32) and beside cuDNN's float32
``relu(conv2d)`` with ``cudnn.benchmark`` off (the plain version) and on (a
yardstick only: the port never calls it).
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from vfidkr_torch.kernels import build  # noqa: E402
from vfidkr_torch.ops import conv_head as CH  # noqa: E402

# (N, C, H, W): DAIN's head at cell 1's 512x320 and at cell 3's B=3
# 256x448, the slow-motion head at 1344x768; then C = 13, and a frame off
# the 8 x 32 tile with W % 4 != 0
TIMED = ((1, 45, 320, 512), (3, 45, 256, 448), (1, 437, 768, 1344))
CHECKS = TIMED + ((1, 13, 64, 192), (2, 5, 37, 75))


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    dev = cs.phase_device()
    build.load_library()
    m = re.search(r"[^\n]*rectify_head_kernel.*?Used[^\n]*", build.BUILD_LOG,
                  re.S)
    print(m.group(0) if m else "(no ptxas report: the library was built "
          "before)")
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for shape in CHECKS:
            cs._compare_k8(shape, *(t.to(dev) for t in cs._head_inputs(g, shape)))
        if args.check_only:
            return
        for shape in TIMED:
            n, c, h, w = shape
            a = [t.to(dev) for t in cs._head_inputs(g, shape)]
            flop = 2 * CH.KSIZE ** 2 * c * CH.CO * n * h * w
            bound = flop / cs.F32_FLOP_S * 1e3
            for name, fn in (("K8", CH.rectify_head),
                             ("cuDNN, benchmark off", CH.rectify_head_plain),
                             ("cuDNN, benchmark on",
                              cs.cudnn_head_benchmarked)):
                ms = ms_per_call(lambda fn=fn: fn(*a))
                print(f"[times] {shape} {name}: {ms:.3f} ms a call, bound "
                      f"{bound:.3f} ms: {bound / ms:.1%} of the f32 peak "
                      f"({flop / ms / 1e9:.2f} TFLOP/s)", flush=True)


if __name__ == "__main__":
    main()
