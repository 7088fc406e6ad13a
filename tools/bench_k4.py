#!/usr/bin/env python3
"""Time K4 (``fused_resblocks``) on one NVIDIA GPU beside cuDNN.

    python3 tools/bench_k4.py

At each of chip_smoke.py's K4 shapes, with CUDA events (median of 30 runs
of 10 after a warm-up): one launch of the kernel (conv1, no residual) and
one of conv2 (residual in place), the wrapper's whole call from an NCHW
input (layout copy and weight packing included), the same six convs as
bf16 ``F.conv2d`` calls on cuDNN on channels-last tensors, and one such
conv alone.  Each time is printed beside the operations' bound at 989
TFLOP/s bf16.  The card's name and power limit come first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.ops import rectify as RB  # noqa: E402

BF16_FLOP_S = 989e12
SHAPES = ((1, 128, 256, 448), (1, 128, 512, 704), (3, 128, 320, 448))


def ms_per_call(fn, iters=30, inner=10) -> float:
    for _ in range(3):
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
    return statistics.median(times)


def cudnn_chain(x, w6):
    h = x
    for k in range(RB.N_CONVS // 2):
        t = F.relu(F.conv2d(h, w6[2 * k], padding=1))
        h = F.relu(F.conv2d(t, w6[2 * k + 1], padding=1) + h)
    return h


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        n, c, h, w = shape
        x = torch.relu(torch.randn(*shape, generator=g)).bfloat16().to(dev)
        w6 = (torch.randn(RB.N_CONVS, c, c, 3, 3, generator=g)
              * (2.0 / (9 * c)) ** 0.5).bfloat16().to(dev)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        taps = RB.pack_trunk_weights(w6)
        out = torch.empty_like(x_cl)
        conv_bound = 2 * c * c * 9 * n * h * w / BF16_FLOP_S * 1e3
        with torch.inference_mode():
            rows = [
                ("K4 conv1 launch", 1, lambda: kernels.launch(
                    "fused_resblocks", x_cl, taps[0], None, out, n, h, w)),
                ("K4 conv2 launch, in place", 1, lambda: kernels.launch(
                    "fused_resblocks", x_cl, taps[1], out, out, n, h, w)),
                ("K4 wrapper call (NCHW in)", 6,
                 lambda: RB.fused_resblocks(x, w6)),
                ("cuDNN chain of 6 (channels-last)", 6,
                 lambda: cudnn_chain(x_cl, w6)),
                ("cuDNN one bf16 conv (channels-last)", 1,
                 lambda: F.conv2d(x_cl, w6[0], padding=1)),
            ]
            for name, convs, fn in rows:
                ms = ms_per_call(fn)
                bound = conv_bound * convs
                print(f"[bench_k4] {shape} {name}: {ms * 1000:.2f} us, bound "
                      f"{bound * 1000:.2f} us ({bound / ms:.1%}, "
                      f"{bound / ms * BF16_FLOP_S / 1e12:.0f} TFLOP/s)")


if __name__ == "__main__":
    main()
