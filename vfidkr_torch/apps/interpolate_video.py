"""N x video frame interpolation on the PyTorch port; counterpart of
``apps/interpolate_video.py`` (reference ``colab_interpolate.py`` and the
ffmpeg extract and re-encode steps of ``Colab_DAIN.ipynb``).

Input: a directory of frames (``--frames-dir``: its ``.png``, ``.jpg`` and
``.jpeg`` files in sorted order, at least two), or a video file
(``--video-in``, decoded by OpenCV where ``cv2`` imports).  Output:
``--out-dir`` keeps the reference naming ``{frame:05d}{offset:03d}.png``,
offset 000 the pass-through input and 1..N-1 the synthesised frames, the
last input written as frame ``n_in``; ``--video-out`` encodes a video at
``fps_in / time_step`` (both sinks may be used together).

``--model DAIN`` synthesises the middle frame (``--time-step 0.5`` only);
``--model DAIN_slowmotion`` synthesises ``1 / time_step - 1`` frames a
pair; ``--model SepConv`` (Niklaus et al., ICCV 2017) the middle frame, in
float32.  ``--compute-dtype bfloat16`` selects the fast-eval lane.  The
weights are random (seed 0) unless ``--torch-checkpoint`` (a reference
``.pth``) or ``--checkpoint`` (a checkpoint of the port's trainer) is
given; both are read by ``vfidkr_torch.training.load_weights``, which loads
the entries the model has and skips the rest.  It runs on the card unless
asked for the CPU (``--device cpu``).

Each frame is replication-padded to a multiple of 128, at least 32 px a
side (1280x720 runs at 1344x768); with ``--spatial-shards n`` > 1 to a
multiple of max(128, 64 n), at least half of it a side, as JAX's driver
pads, so that each shard's H/n + 2 ``--halo`` rows keep the networks' /64.
``--spatial-shards n`` row-shards each forward over n devices with halo
exchange (``vfidkr_torch.parallel.spatial``, one thread a shard): the first
n cards, or n threads on the CPU with ``--device cpu``; like JAX's, it is
the tiled approximation of the whole-frame forward, for frames that do not
fit on one card.  ``outputs[--save-which]`` (0 the blend, 1 the rectified;
by default the network's last output: DAIN's rectified frames, SepConv's
only one) is unpadded, clipped to [0, 1] and rounded to the 8-bit grid on
the device, and a pair's frames are copied to the host at once.
The forward runs under ``torch.inference_mode()``.  PNG frames are read
and written without PIL (``vfidkr_torch.utils.image_io``); JPEG input needs
PIL.  Decoding runs ahead on a prefetch thread
(``vfidkr_torch.data.vimeo90k.prefetch``); PNG encoding runs behind on a
pool of four threads.

The last line of standard output is JAX's summary: input and synthesised
frame counts, the frame rates, the wall time and the synthesised frames a
second.  The line before it, on standard error, is the seconds spent
decoding, in the forwards (each up to its frames on the host) and encoding,
by the driver's own timers; the three overlap, so their shares of the wall
time may sum past 1.

Left out of JAX's flags: ``--depth-impl packed`` (a TPU workaround).

Usage:
  python -m vfidkr_torch.apps.interpolate_video --frames-dir in/ \\
      --out-dir out/ [--time-step 0.25 --model DAIN_slowmotion | --model
      SepConv] [--compute-dtype bfloat16] [--torch-checkpoint best.pth]
      [--device cuda] [--spatial-shards 2 --halo 64]
  python -m vfidkr_torch.apps.interpolate_video --video-in clip.mp4 \\
      --video-out out.mp4 --time-step 0.25 --model DAIN_slowmotion
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vfidkr_torch.config import (NET_NAMES, EvalConfig, ModelConfig,
                                 add_device_flag, add_model_flags,
                                 add_save_which_flag)
from vfidkr_torch.data.vimeo90k import prefetch
from vfidkr_torch.utils import pad_to_multiple, unpad
from vfidkr_torch.utils.image_io import read_rgb, write_png
from vfidkr_torch.utils.profiling import span

FRAME_EXTS = (".png", ".jpg", ".jpeg")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames-dir", default=None,
                    help="input: directory of numbered frames")
    ap.add_argument("--video-in", default=None,
                    help="input: video file (decoded by OpenCV)")
    ap.add_argument("--out-dir", default=None,
                    help="output: PNG frames, reference naming convention")
    ap.add_argument("--video-out", default=None,
                    help="output: video file at fps_in / time_step")
    ap.add_argument("--fps-in", type=float, default=None,
                    help="input frame rate for --video-out (default: from "
                         "--video-in metadata, else 30)")
    ap.add_argument("--fourcc", default="mp4v",
                    help="--video-out codec fourcc (OpenCV VideoWriter)")
    ap.add_argument("--time-step", type=float, default=0.5)
    ap.add_argument("--model", default="DAIN", choices=NET_NAMES)
    weights = ap.add_mutually_exclusive_group()
    weights.add_argument("--torch-checkpoint", default=None,
                         help="a reference .pth state dict")
    weights.add_argument("--checkpoint", default=None,
                         help="a checkpoint of the port's trainer")
    add_save_which_flag(ap)
    ap.add_argument("--spatial-shards", type=int, default=1,
                    help="row-shard frames over N devices with halo exchange"
                         " (N threads on the CPU with --device cpu)")
    ap.add_argument("--halo", type=int, default=64,
                    help="halo rows per shard (>= max motion + op support)")
    add_model_flags(ap)
    add_device_flag(ap)
    return ap


def _video_frames(cap):
    """(H, W, 3) uint8 RGB frames of an open ``cv2.VideoCapture``."""
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                return
            yield np.ascontiguousarray(bgr[:, :, ::-1])
    finally:
        cap.release()


def _timed(frames, stages: dict):
    """``frames``, the time of each ``next`` added to stages["decode"]."""
    while True:
        t = time.perf_counter()
        try:
            frame = next(frames)
        except StopIteration:
            return
        stages["decode"] += time.perf_counter() - t
        yield frame


def pad_rule(spatial_shards: int = 1) -> tuple[int, int]:
    """(multiple, min_pad) of the frames' padding, as JAX's driver pads
    (``apps/interpolate_video.py:138-144``): with n > 1 shards each shard's
    H/n + 2 halo rows must keep the networks' /64, so H pads to a multiple
    of 64 n (and 128), and a dim already divisible keeps the multiple."""
    if spatial_shards == 1:
        return EvalConfig.pad_multiple, EvalConfig.min_pad
    multiple = max(128, 64 * spatial_shards)
    return multiple, multiple // 2


def to_input(frame: np.ndarray, device, spatial_shards: int = 1):
    """(H, W, 3) uint8 -> ((1, 3, H', W') float32 on ``device``, pads): the
    value of JAX's ``frame / 255.0``, replication-padded for the model."""
    with span("vfidkr/driver/to_input"):
        x = torch.from_numpy(frame).to(device).permute(2, 0, 1)[None]
        multiple, min_pad = pad_rule(spatial_shards)
        return pad_to_multiple(x.contiguous().float() / 255.0,
                               multiple=multiple, min_pad=min_pad)


def sharded_forward(model: torch.nn.Module, spatial_shards: int, halo: int,
                    devices=None):
    """``model``'s forward row-sharded over ``devices`` (default: the first
    ``spatial_shards`` CUDA devices, or as many threads on the CPU for a
    model on the CPU), as JAX's driver wraps its forward in
    ``shard_model_rows``; each device runs a replica of the model."""
    from vfidkr_torch.parallel.spatial import cuda_devices, shard_model_rows
    home = next(model.parameters()).device
    if devices is None:
        devices = ([home] * spatial_shards if home.type == "cpu"
                   else cuda_devices(spatial_shards))
    devices = [torch.device(d) for d in devices]
    replicas = {d: model if d == home else copy.deepcopy(model).to(d)
                for d in set(devices)}
    # only the frames cross the shards (JAX's driver shards its frames too)
    return shard_model_rows(
        lambda a, b: {"outputs": replicas[a.device](a, b)["outputs"]},
        spatial_shards, halo, devices)


def frames_between(model, a: torch.Tensor, b: torch.Tensor,
                   pads, save_which: int = EvalConfig.save_which
                   ) -> torch.Tensor:
    """Padded (1, 3, H', W') frames -> the synthesised frames between them,
    (K, H, W, 3) uint8 on the device: each unpadded by ``pads``, clipped to
    [0, 1] and rounded to the 8-bit grid.  ``model`` is the model, or a
    sharded forward of it (``sharded_forward``)."""
    with torch.inference_mode():
        outs = model(a, b)["outputs"][save_which]
        with span("vfidkr/driver/finish"):
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            frames = torch.cat([unpad(o, pads) for o in outs]).clamp(0.0, 1.0)
            return torch.round(frames * 255.0).to(torch.uint8).permute(
                0, 2, 3, 1).contiguous()


def _save(path: str, frame: np.ndarray) -> float:
    t = time.perf_counter()
    write_png(path, frame)
    return time.perf_counter() - t


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.video_in is None) == (args.frames_dir is None):
        ap.error("give exactly one input: --frames-dir or --video-in")
    if args.out_dir is None and args.video_out is None:
        ap.error("give at least one output: --out-dir and/or --video-out")
    try:
        config = ModelConfig.from_args(args, net_name=args.model,
                                       time_step=args.time_step)
    except ValueError as err:
        ap.error(str(err))

    def opencv(flag):
        try:
            import cv2
        except ImportError:
            ap.error(f"{flag} needs OpenCV (cv2), which is not installed; "
                     f"use --frames-dir / --out-dir")
        return cv2

    cv2 = opencv("--video-out") if args.video_out else None
    fps_in = args.fps_in
    if args.frames_dir:
        names = sorted(f for f in os.listdir(args.frames_dir)
                       if f.lower().endswith(FRAME_EXTS))
        if len(names) < 2:
            ap.error(f"need at least two frames in {args.frames_dir}, found "
                     f"{len(names)}")
        frames = (read_rgb(os.path.join(args.frames_dir, n)) for n in names)
    else:
        cv2 = opencv("--video-in")
        cap = cv2.VideoCapture(args.video_in)
        if not cap.isOpened():
            ap.error(f"cannot open --video-in {args.video_in}")
        fps_in = fps_in or cap.get(cv2.CAP_PROP_FPS) or None
        frames = _video_frames(cap)
    fps_in = fps_in or 30.0
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    device = torch.device(args.device)
    model = config.build(torch.Generator().manual_seed(0))
    ckpt = args.torch_checkpoint or args.checkpoint
    if ckpt:
        from vfidkr_torch.training import load_weights
        loaded, skipped = load_weights(model, ckpt)
        print(f"loaded {len(loaded)} tensors ({len(skipped)} skipped)",
              file=sys.stderr)
    model = model.to(device).eval()
    if args.spatial_shards < 1:
        ap.error("--spatial-shards must be at least 1")
    forward = (model if args.spatial_shards == 1 else
               sharded_forward(model, args.spatial_shards, args.halo))

    first = next(frames, None)
    if first is None:
        ap.error("input has no frames")
    stages = {"decode": 0.0, "forward": 0.0, "encode": 0.0}
    source = _timed(frames, stages)

    def frame_pairs():
        prev = first
        for nxt in source:
            yield prev, nxt
            prev = nxt

    writer = None

    def emit_video(frame):
        nonlocal writer
        if writer is None:
            writer = cv2.VideoWriter(
                args.video_out, cv2.VideoWriter_fourcc(*args.fourcc),
                fps_in / args.time_step, (frame.shape[1], frame.shape[0]))
            if not writer.isOpened():
                raise RuntimeError(f"VideoWriter failed for {args.video_out} "
                                   f"({args.fourcc})")
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))   # RGB -> BGR

    pending = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        def emit(idx, offset, frame):
            if args.out_dir:
                pending.append(pool.submit(_save, os.path.join(
                    args.out_dir, f"{idx:05d}{offset:03d}.png"), frame))
            if args.video_out:
                emit_video(frame)

        t0 = time.perf_counter()
        produced, n_in, last = 0, 1, first
        b_in = None
        for idx, (a, b) in enumerate(prefetch(frame_pairs(), 2), start=1):
            n_in += 1
            last = b
            t = time.perf_counter()
            # each frame goes to the card and is padded once: pair k's b is
            # pair k+1's a
            a_in, pads = (to_input(a, device, args.spatial_shards)
                          if b_in is None else b_in)
            b_in = to_input(b, device, args.spatial_shards)
            outs = frames_between(forward, a_in, b_in[0], pads,
                                  args.save_which)
            outs = outs.cpu().numpy()
            stages["forward"] += time.perf_counter() - t
            emit(idx, 0, a)
            for k, frame in enumerate(outs, start=1):
                emit(idx, k, frame)
                produced += 1
        emit(n_in, 0, last)
        stages["encode"] = sum(f.result() for f in pending)
    if writer is not None:
        writer.release()
    dt = time.perf_counter() - t0

    summary = {
        "input_frames": n_in,
        "interpolated_frames": produced,
        "fps_in": fps_in,
        "fps_out": (fps_in / args.time_step) if args.video_out else None,
        "wall_s": dt,
        "interp_frames_per_sec": produced / dt if dt > 0 else None,
    }
    print(json.dumps({f"{k}_s": v for k, v in stages.items()}),
          file=sys.stderr)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
