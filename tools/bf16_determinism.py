#!/usr/bin/env python3
"""Where the video cell's run-to-run change comes from, on one NVIDIA GPU.

    python3 tools/bf16_determinism.py [--pairs 1]

Runs chip_smoke.py's DAINSlowMotion(0.25) (its seeded, tamed weights) on
the first pair of its 1280x720 video clip, padded to 1344x768 as the video
driver pads it, twice under each configuration, and compares the two runs:
the rectified frames' largest difference in 8-bit levels and the number of
values that differ, and the first module (in the order the modules finish)
whose output differs bit for bit.  The configurations, in the bf16 lane
and in float32:

* ``as run``: the paths' kernels;
* ``K2 on the host``: ``flow_project_scatter`` replaced by its plain
  version run on the CPU, which sums each cell's adds in index order;
* ``cuDNN deterministic``: ``torch.backends.cudnn.deterministic = True``;
* ``K4 plain`` (bf16): ``fused_resblocks`` replaced by its plain version;
* their combinations.

The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from vfidkr_torch.models import resblock  # noqa: E402
from vfidkr_torch.ops.rectify import fused_resblocks_plain  # noqa: E402
from vfidkr_torch.utils import pad_to_multiple  # noqa: E402

_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
         torch.float32: torch.int32, torch.float64: torch.int64}


def checksum(t: torch.Tensor) -> tuple:
    """Two sums over the tensor's bits: any flipped bit moves them."""
    x = t.detach().contiguous()
    x = x.view(_BITS[x.dtype]) if x.dtype in _BITS else x
    x = x.to(torch.int64).reshape(-1)
    return int(x.sum()), int((x * (x >> 5)).sum())


def tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from tensors(o)


def traced_forward(model, a, b) -> tuple:
    """The rectified frames (uint8 on the grid) and each module's output
    checksums, in the order the modules finish."""
    trace = []
    hooks = [m.register_forward_hook(
        lambda mod, _i, out, name=name: trace.append(
            (name, [checksum(t) for t in tensors(out)])))
        for name, m in model.named_modules() if name]
    try:
        with torch.inference_mode():
            outs = model(a, b)["outputs"][1]
            frames = torch.cat(list(outs)).clamp(0, 1).mul(255).round()
            frames = frames.to(torch.uint8).cpu().numpy()
    finally:
        for h in hooks:
            h.remove()
    return frames, trace


@contextlib.contextmanager
def configured(k2_host: bool, cudnn_det: bool, k4_plain: bool):
    saved = torch.backends.cudnn.deterministic, resblock.fused_resblocks
    torch.backends.cudnn.deterministic = cudnn_det
    if k4_plain:
        resblock.fused_resblocks = fused_resblocks_plain
    try:
        with cs.k2_summed_on_the_host() if k2_host else \
                contextlib.nullcontext():
            yield
    finally:
        torch.backends.cudnn.deterministic, resblock.fused_resblocks = saved


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args(argv)
    dev = cs.phase_device()
    frames = cs.make_clip(torch.Generator().manual_seed(1), args.pairs + 1,
                          cs.VIDEO_H, cs.VIDEO_W)
    to = lambda f: pad_to_multiple(  # noqa: E731
        torch.from_numpy(f).to(dev).permute(2, 0, 1)[None].contiguous()
        .float() / 255.0, multiple=128, min_pad=32)[0]
    pairs = [(to(x), to(y)) for x, y in zip(frames[:-1], frames[1:])]
    f32 = cs.make_slowmo_model().to(dev).eval()
    bf16 = cs._bf16_twin(f32).eval()
    configs = [("as run", False, False, False),
               ("K2 on the host", True, False, False),
               ("cuDNN deterministic", False, True, False),
               ("K2 on the host, cuDNN deterministic", True, True, False),
               ("K4 plain", False, False, True),
               ("K2 on the host, K4 plain", True, False, True),
               ("all three", True, True, True)]
    for lane, model in (("bf16", bf16), ("float32", f32)):
        for name, k2, det, k4 in configs:
            if k4 and lane == "float32":
                continue
            with configured(k2, det, k4):
                diffs, first = [], None
                for a, b in pairs:
                    one, trace1 = traced_forward(model, a, b)
                    two, trace2 = traced_forward(model, a, b)
                    diffs.append(np.abs(one.astype(np.int16)
                                        - two.astype(np.int16)))
                    for (m1, c1), (m2, c2) in zip(trace1, trace2):
                        if first is None and (m1 != m2 or c1 != c2):
                            first = m1
            diff = np.stack(diffs)
            print(f"[determinism] {lane} lane, {name}: two runs differ by "
                  f"max {int(diff.max())} levels, {int((diff > 0).sum())} of "
                  f"{diff.size} values; the first module whose output "
                  f"differs: {first}", flush=True)


if __name__ == "__main__":
    main()
