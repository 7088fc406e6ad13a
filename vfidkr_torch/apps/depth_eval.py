"""Depth evaluation of the MegaDepth hourglass on the PyTorch port;
counterpart of ``apps/depth_eval.py`` (reference
``MegaDepth/rmse_error_main.py`` for the scale-invariant RMSE and
``MegaDepth/SDR_compute.py`` for the ordinal SDR error), with the metrics
of ``vfidkr_torch.utils.depth_eval``.

Dataset layout, one directory:

  <data-root>/<name>.png (or .jpg)   RGB (or grayscale) image
  <data-root>/<name>.h5              h5 with dataset "/depth" (float, m)
  <data-root>/<name>.sdr.npz         optional SfM ordinal pairs: int arrays
                                     xA, yA, xB, yB and gt in {-1, 0, 1}

Per sample, as the reference's ``image_folder.load_MD`` (:54-93): the
image /255 resized bilinearly to (H, W); the depth clamped to its [1, 98]
valid-pixel percentiles (values outside -> 0) when it has more than 10
valid pixels, resized nearest-neighbour; mask = depth > 1e-8, and the depth
where the mask is off set to 1.0 (:109).  si-RMSE runs on log(gt) over the
mask; SDR classifies exp(log_pred) ratios at threshold 1.1.

The weights are random (seed 0) unless ``--torch-checkpoint`` names a bare
MegaDepth ``.pth`` (``module.``-prefixed, ``HG_model.py:39``), a
DAIN_slowmotion state dict (its ``depthNet.*`` entries) or a checkpoint of
the port's trainer; the port's modules carry the reference's names, so the
entries load by key (``filtered_partial_load``) with no key map.  JAX's
Orbax ``--checkpoint`` is not ported.  It runs on the card unless asked for
the CPU (``--device cpu``).

``evaluate_depth`` is the in-memory core, which takes arrays; the CLI adds
the loading.  The resize is PIL's, computed in numpy (``_resize``), and PNG
decoding needs no PIL, so a ``.png`` image with an ``.sdr.npz`` sample runs
where PIL is absent (the card's machine); an ``.h5`` depth needs ``h5py``
and a ``.jpg`` image PIL.

Usage:
  python -m vfidkr_torch.apps.depth_eval --data-root /data/md_eval \\
      [--torch-checkpoint best.pth] [--input-height 256 --input-width 320] \\
      [--limit N] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from vfidkr_torch.config import add_device_flag
from vfidkr_torch.utils.depth_eval import scale_invariant_rmse, sdr_counts
from vfidkr_torch.utils.image_io import read_rgb

SDR_KEYS = ("xA", "yA", "xB", "yB", "gt")


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64: PIL's BILINEAR coefficients for one axis
    (``precompute_coeffs`` of its ``Resample.c``): a triangle of support 1,
    widened by the factor when shrinking, each output's taps normalised to
    sum to 1."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale
    ss = 1.0 / filterscale
    out = np.zeros((n_out, n_in))
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        k = np.maximum(1.0 - np.abs((np.arange(lo, hi) - center + 0.5) * ss),
                       0.0)
        total = sum(k.tolist())           # in order, as PIL sums
        out[xx, lo:hi] = k / total if total != 0.0 else k
    return out


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index for each output (``ImagingScaleAffine``):
    the position starts at half a step and adds the step, in float64, and
    is truncated; -1 where it leaves the source."""
    step = n_in / n_out
    pos = np.cumsum(np.r_[step * 0.5, np.full(n_out - 1, step)])
    idx = pos.astype(np.int64)
    return np.where(idx < n_in, idx, -1)


def _resize(img: np.ndarray, hw, nearest: bool = False) -> np.ndarray:
    """PIL's mode-F BILINEAR or NEAREST resize of each channel of a float
    (H, W) or (H, W, C) image to ``hw``, as JAX's ``_resize`` calls PIL (the
    reference uses skimage); numpy only, since the card's machine has no
    PIL.  Bilinear runs the horizontal pass, rounds to float32 and then the
    vertical pass, as PIL does, each in float64; it equals PIL's to a
    float32 rounding of the sums, whose order differs."""
    h, w = hw
    img = np.asarray(img, np.float32)
    if img.shape[:2] == (h, w):
        return img.copy()
    if nearest:
        iy, ix = _nearest_index(img.shape[0], h), _nearest_index(
            img.shape[1], w)
        out = img[np.maximum(iy, 0)][:, np.maximum(ix, 0)]
        inside = (iy >= 0)[:, None] & (ix >= 0)[None, :]
        return np.where(inside.reshape(inside.shape + (1,) * (img.ndim - 2)),
                        out, np.float32(0))
    out = img
    if img.shape[1] != w:
        m = _bilinear_weights(img.shape[1], w)
        out = np.einsum("yx...,ux->yu...", out.astype(np.float64), m).astype(
            np.float32)
    if img.shape[0] != h:
        m = _bilinear_weights(img.shape[0], h)
        out = np.einsum("y...,vy->v...", out.astype(np.float64), m).astype(
            np.float32)
    return out


def load_image(img_path: str, hw) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], resized bilinearly to ``hw``."""
    img = np.asarray(read_rgb(img_path), np.float32) / 255.0
    return _resize(img, hw).astype(np.float32)


def load_sample(img_path: str, h5_path: str, hw) -> tuple:
    """``image_folder.load_MD`` (:54-93) and the gt fill at :109 ->
    (image, gt, mask)."""
    import h5py

    img = load_image(img_path, hw)
    with h5py.File(h5_path, "r") as f:
        gt = np.asarray(f["/depth"], dtype=np.float32)

    valid = gt > 1e-8
    if np.sum(valid) > 10:
        hi = np.percentile(gt[valid], 98)
        lo = np.percentile(gt[valid], 1)
        gt = np.where(gt > hi, 0.0, gt)
        gt = np.where(gt < lo, 0.0, gt)
    max_depth = np.max(gt) + 1e-9
    gt = _resize((gt / max_depth).astype(np.float32), hw,
                 nearest=True) * max_depth
    mask = (gt > 1e-8).astype(np.float32)
    gt = np.where(mask < 0.1, 1.0, gt)           # image_folder.py:109
    return img, gt.astype(np.float32), mask


def find_samples(root: str, limit: Optional[int] = None):
    """(image path, stem) of each image with a ``.h5`` or ``.sdr.npz``."""
    imgs = sorted(p for ext in ("png", "jpg", "jpeg")
                  for p in glob.glob(os.path.join(root, f"*.{ext}")))
    samples = [(p, os.path.splitext(p)[0]) for p in imgs
               if any(os.path.exists(os.path.splitext(p)[0] + s)
                      for s in (".h5", ".sdr.npz"))]
    return samples[:limit] if limit else samples


def load_samples(samples, hw):
    """(image, gt or None, mask or None, SDR pairs or None) per sample."""
    for img_path, stem in samples:
        if os.path.exists(stem + ".h5"):
            img, gt, mask = load_sample(img_path, stem + ".h5", hw)
        else:
            img, gt, mask = load_image(img_path, hw), None, None
        sdr = None
        if os.path.exists(stem + ".sdr.npz"):
            with np.load(stem + ".sdr.npz") as z:
                sdr = {k: z[k] for k in SDR_KEYS}
        yield img, gt, mask, sdr


def load_megadepth(model: torch.nn.Module, path: str):
    """A bare MegaDepth ``.pth``, a DAIN_slowmotion state dict or a port
    trainer checkpoint into ``model`` -> (loaded, skipped) keys."""
    from vfidkr_torch.training.checkpoint import filtered_partial_load
    data = torch.load(path, map_location="cpu", weights_only=True)
    for entry in ("model", "state_dict"):
        if isinstance(data.get(entry), dict):
            data = data[entry]
            break
    sd = {k.removeprefix("module."): v for k, v in data.items()}
    if any(k.startswith("depthNet.") for k in sd):
        sd = {k.removeprefix("depthNet."): v for k, v in sd.items()
              if k.startswith("depthNet.")}
    return filtered_partial_load(model, sd)


def evaluate_depth(model: torch.nn.Module,
                   samples: Iterable[Tuple[np.ndarray, Optional[np.ndarray],
                                           Optional[np.ndarray],
                                           Optional[dict]]],
                   device) -> dict:
    """The in-memory core: ``samples`` of ((H, W, 3) float32 image, (H, W)
    depth or None, (H, W) mask or None, SDR pairs or None), as
    ``load_samples`` gives them.  Returns JAX's result: the image count, the
    mean si-RMSE over the images with a depth, and the SDR error rates
    (equal, unequal, total) with the pair count."""
    device = torch.device(device)
    total_rmse, count, images = 0.0, 0, 0
    sdr_err = np.zeros(3, np.int64)
    sdr_n = np.zeros(3, np.int64)
    on = lambda a, dtype=None: torch.as_tensor(np.asarray(a), dtype=dtype,
                                                device=device)
    with torch.inference_mode():
        for img, gt, mask, sdr in samples:
            images += 1
            x = on(np.ascontiguousarray(img.transpose(2, 0, 1))[None])
            log_pred = model(x)[0, 0]                 # (H, W) log-depth
            if gt is not None:
                # per-image loss summed, divided by the image count at the
                # end (rmse_error_main.py:33-60)
                total_rmse += float(scale_invariant_rmse(
                    log_pred, torch.log(on(gt)), on(mask)))
                count += 1
            if sdr is not None:
                err, n = sdr_counts(log_pred, *(on(sdr[k], torch.long)
                                                for k in SDR_KEYS))
                sdr_err += err.cpu().numpy()
                sdr_n += n.cpu().numpy()

    result = {"images": images}
    if count:
        result["si_rmse"] = total_rmse / count      # rmse_error_main.py:60
        result["rmse_images"] = count
    if sdr_n[2] > 0:
        # SDR_compute.py prints the EQUAL / INEQUAL / TOTAL disagreement
        result["sdr"] = {
            "equal": float(sdr_err[0]) / max(int(sdr_n[0]), 1),
            "unequal": float(sdr_err[1]) / max(int(sdr_n[1]), 1),
            "total": float(sdr_err[2]) / int(sdr_n[2]),
            "pairs": int(sdr_n[2]),
        }
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--torch-checkpoint", default=None,
                    help="a bare MegaDepth .pth (module.-prefixed), a "
                         "DAIN_slowmotion state dict (depthNet.* keys) or a "
                         "checkpoint of the port's trainer")
    # the reference evaluates 240x320 / 320x240 (rmse_error_main.py:12-24);
    # the hourglass needs /32-divisible frames, so the default is the
    # nearest such size
    ap.add_argument("--input-height", type=int, default=256)
    ap.add_argument("--input-width", type=int, default=320)
    ap.add_argument("--limit", type=int, default=None)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from vfidkr_torch.models.megadepth import MegaDepthHourglass

    samples = find_samples(args.data_root, args.limit)
    if not samples:
        result = {"error": "no <name>.{png,jpg}+<name>.h5 pairs under "
                           f"{args.data_root}"}
        print(json.dumps(result))
        return result
    model = MegaDepthHourglass(generator=torch.Generator().manual_seed(0))
    if args.torch_checkpoint:
        loaded, skipped = load_megadepth(model, args.torch_checkpoint)
        print(f"loaded {len(loaded)} tensors from {args.torch_checkpoint} "
              f"({len(skipped)} skipped)", file=sys.stderr)
    model = model.to(torch.device(args.device)).eval()
    hw = (args.input_height, args.input_width)
    result = evaluate_depth(model, load_samples(samples, hw), args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(1 if "error" in main() else 0)
