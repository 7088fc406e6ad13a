"""Triplet-directory eval (UCF/Middlebury-style) on the PyTorch port;
counterpart of ``apps/demo_middlebury.py`` (reference ``demo_MiddleBury.py``).

Each sequence directory holds a frame pair and its ground-truth middle
frame.  Every frame is replication-padded to a multiple of 128 (at least 32
px a side, ``:294-312``), DAIN synthesises the middle frame, which is
unpadded, clipped to [0, 1] and rounded to the 8-bit grid, and IE, PSNR and
SSIM are taken against the ground truth (``:364-397``).

Usage:
  python -m vfidkr_torch.apps.demo_middlebury --root <dir> \\
      [--first im2.png --second im4.png --gt im3.png] [--out-dir <dir>] \\
      [--torch-checkpoint best.pth] [--compute-dtype bfloat16] \\
      [--save-which 1] [--measure-time] [--device cuda]

``--compute-dtype bfloat16`` selects the fast-eval lane.  It runs on the
card unless asked for the CPU (``--device cpu``).  Without a checkpoint the
weights are random (seed 0).  The CLI reads and writes PNGs with PIL;
``evaluate`` is the in-memory core, which takes frame arrays.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Iterable, Tuple

import numpy as np
import torch

from vfidkr_torch.config import (add_device_flag, add_model_flags,
                                 build_eval_model)
from vfidkr_torch.utils import (interpolation_error, pad_to_multiple, psnr,
                                ssim, unpad)


def to_tensor(frame: np.ndarray, device) -> torch.Tensor:
    """(H,W,3) float32 in [0, 1] -> (1,3,H,W) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        frame.transpose(2, 0, 1)))[None].to(device)


def interpolate_pair(model: torch.nn.Module, x0: torch.Tensor,
                     x1: torch.Tensor, save_which: int = 1) -> torch.Tensor:
    """(B,3,H,W) frame pairs -> the synthesised middle frames, padded for
    the model, unpadded, clipped to [0, 1]: ``outputs[save_which]`` (0 the
    blend, 1 the rectified)."""
    x0p, pads = pad_to_multiple(x0)
    x1p, _ = pad_to_multiple(x1)
    with torch.inference_mode():
        out = model(x0p, x1p)["outputs"][save_which]
    return unpad(out, pads).clamp(0.0, 1.0)


def _forward_ms(model, x0, x1, iters=5) -> float:
    """Median CUDA-event ms of ``iters`` padded forwards, after one."""
    x0p, _ = pad_to_multiple(x0)
    x1p, _ = pad_to_multiple(x1)
    times = []
    with torch.inference_mode():
        model(x0p, x1p)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(x0p, x1p)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def evaluate(model: torch.nn.Module,
             pairs: Iterable[Tuple[str, np.ndarray, np.ndarray, np.ndarray]],
             device, save_which: int = 1, measure_time: bool = False):
    """The in-memory core: ``pairs`` of (name, first, second, ground truth),
    (H,W,3) float32 frames in [0, 1].  Returns (per-pair results, summary):
    each result has the name, IE, PSNR, SSIM and the synthesised frame as
    (H,W,3) uint8; the summary the reference script's averages and, with
    ``measure_time`` (CUDA only), the device time a pair, one median per
    padded shape."""
    device = torch.device(device)
    if measure_time and device.type != "cuda":
        raise ValueError("--measure-time times the card: it needs a CUDA "
                         "device")
    results, times = [], {}
    for name, first, second, gt in pairs:
        x0, x1 = to_tensor(first, device), to_tensor(second, device)
        gt_t = to_tensor(gt, device)
        out = interpolate_pair(model, x0, x1, save_which)
        out255 = torch.round(out * 255.0)
        gt255 = torch.round(gt_t * 255.0)
        results.append({
            "name": name,
            "ie": float(interpolation_error(out255, gt255)),
            "psnr": float(psnr(out255, gt255)),
            "ssim": float(ssim(out, gt_t)),
            "frame": out255[0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()})
        shape = tuple(pad_to_multiple(x0)[0].shape)
        if measure_time and shape not in times:
            times[shape] = _forward_ms(model, x0, x1) / 1000.0
    mean = lambda key: float(np.mean([r[key] for r in results]))
    summary = {"avg_ie": mean("ie"), "avg_psnr": mean("psnr"),
               "avg_ssim": mean("ssim"),
               "device_time_per_pair_s": (float(np.mean(list(times.values())))
                                          if times else None),
               "sequences": len(results)}
    return results, summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--first", default="im2.png")
    ap.add_argument("--second", default="im4.png")
    ap.add_argument("--gt", default="im3.png")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--torch-checkpoint", default=None,
                    help="a reference .pth or a checkpoint of the port's "
                         "trainer")
    ap.add_argument("--save-which", type=int, default=1,
                    help="0: blended output, 1: rectified")
    ap.add_argument("--measure-time", action="store_true",
                    help="time each padded shape's forward on the card "
                         "(CUDA events, median of 5)")
    add_model_flags(ap)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from PIL import Image

    model = build_eval_model(args)
    seqs = sorted(d for d in os.listdir(args.root)
                  if os.path.isdir(os.path.join(args.root, d)))

    def load(seq, name):
        with Image.open(os.path.join(args.root, seq, name)) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0

    pairs = ((seq, load(seq, args.first), load(seq, args.second),
              load(seq, args.gt)) for seq in seqs)
    results, summary = evaluate(model, pairs, args.device, args.save_which,
                                args.measure_time)
    for r in results:
        if args.out_dir:
            os.makedirs(os.path.join(args.out_dir, r["name"]), exist_ok=True)
            Image.fromarray(r["frame"]).save(
                os.path.join(args.out_dir, r["name"], args.gt))
        print(f"{r['name']}: IE {r['ie']:.4f} PSNR {r['psnr']:.4f} "
              f"SSIM {r['ssim']:.5f}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
