#!/usr/bin/env python3
"""Drive the PyTorch port's paths, the DAIN eval forward, the DAIN train
step, the DAIN_slowmotion 4x eval forward and the DAIN_slowmotion train step
in float32, the same two eval forwards in the bf16 fast-eval lane, the
Middlebury eval app's core in that lane, the N x video driver on a 1280x720
PNG clip in both lanes, the trainer on PNG triplets from disk with a resume,
the depth-eval core, the row-sharded op chains and video forward, the
data-parallel train step, and SepConv through the video driver at 1080p, on
one NVIDIA GPU through its hand-written CUDA kernels; then the reference's
dormant ops, DAIN's vestigial children and the PNG formats past 8-bit, and
check them.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script exits
non-zero and prints no result line.  The paths are checked and timed first
(3-5a, then 5b-5g), the kernel cases next (6), and every torch.profiler
session comes last (7), since host-bound timings read slower after one:

1. device: needs CUDA (no CPU fallback); prints the card's name and power
   limit as nvidia-smi gives them; turns TF32 off for convolutions and
   matmuls, so the float32 path is held to float32 references;
2. build: compiles vfidkr_torch/csrc/*.cu with nvcc (into build/, on first
   use, one nvcc per source, all at once) and loads the library;
3. slice: DAIN eval at full width from seeded random weights, frames
   (1,3,256,448) on the 8-bit grid; each forward kernel's counter must rise
   by exactly 1 in one forward (K8, the rectifier's float32 head, too); the
   outputs are held to the same model run on the CPU, where every op takes
   its plain version; its ms/frame (CUDA
   events, median of 50 after 10 warm-up forwards);
4. slowmo: DAINSlowMotion(0.25) at full width, the same frames, 3 frames a
   pair; one forward launches K1, K7, K2, K3 and K8 exactly 3 times each; the
   outputs are held to the same model on the CPU; ms per forward and per
   synthesised frame (median of 50 after 10 warm-up), peak memory;
5. train: DAIN().train() at full width, B=3 triplets of 256x448 made in
   memory; 5 train steps, each launching the forward kernels (K8 too) and
   the backward kernels once and the hole fill never, with a finite loss and
   every Adamax group moved; one eval step (hole fill, no backward kernel);
   one train step's gradients held to the same step on the CPU, per leaf;
   the train step's time (median of 20 after 5 warm-up) and peak memory;
5a. slowmo_train: DAINSlowMotion(0.5).train() at full width, B=3 triplets
   of 256x448, the context and depth nets frozen; 5 train steps, each
   launching K1, K7, K2, K5 and the depth projection's backward once and the
   hole fill never, with a finite loss, every Adamax group moved and the
   frozen nets' parameters and MegaDepth's BN buffers unchanged bit for bit;
   one eval step (K1, K7, K2, K3 once each); one train step at B=1 128x128
   held to the same step on the CPU (the loss, each grouped gradient leaf);
   the step's time (median of 20 after 5 warm-up) and peak memory;
5b. eval_bf16: DAIN(compute_dtype="bfloat16") on the weights and frames of
   phase 3: one forward launches K1-K3 once and K4 (fused_resblocks) six
   times, one launch per conv of the rectifier's trunk; its frames and
   filters held to the float32 lane's (LANE_* below); its ms/frame as
   phase 3's;
5c. slowmo_bf16: DAINSlowMotion(0.25, "bfloat16") likewise: K1, K7, K2, K3
   3 times and K4 18 times (three rectifier calls) a forward; held to the
   float32 slow-motion forward; ms a forward and a frame, peak memory;
5d. middlebury: the Middlebury eval app's in-memory core
   (vfidkr_torch.apps.demo_middlebury.evaluate) in the bf16 lane on three
   synthetic 640x480 pairs on the 8-bit grid, padded to 704x512: K4 at
   (1,128,512,704); its IE, PSNR and SSIM, and its device time a pair;
5e. video: the video driver (vfidkr_torch.apps.interpolate_video.main) on a
   4-frame 1280x720 PNG clip whose rows are filtered as PIL's encoder
   filters them (phase 3's smooth scene moved (5, -3) px a frame),
   DAINSlowMotion(0.25) from a reference-layout .pth of phase 4's weights,
   in the float32 and the bf16 lane, at 1344x768 (padded): 4 pass-through
   and 9 synthesised PNGs, the pass-through equal to the input, each
   synthesised frame against the same model run in memory on the card
   (VIDEO_LEVELS, VIDEO_SHARE), the launches exactly (3 x phase 4's, and K4
   54 in bf16), its interp_frames_per_sec and its own decode / forward /
   encode split, peak memory; in the bf16 lane also the in-memory forward
   run twice with K2 summed on the host and cuDNN deterministic, which must
   agree bit for bit (the two sources of its run-to-run change,
   tools/bf16_determinism.py); then the bf16 lane again on the clip as the
   port's writer writes it (Up rows);
   before it, the host's PNG times (write_png, read_png of its files and of
   frames filtered as PIL filters them);
5f. train_from_disk: the trainer (vfidkr_torch.apps.train.main) on 18
   synthetic 256x448 triplets written by vfidkr_torch.data.synthetic and
   re-encoded with PIL's row filters, 2 epochs of 4 steps at B=3, then
   --resume to 3, the frames decoded by the trainer's default 4 worker
   processes: the epoch seam, the Adamax step count and the plateau state
   carried over; then its ms/step from disk (2 epochs of 10 steps, the
   second the reading) beside phase 5's in memory, the same decoded on the
   prefetch thread, on the triplets as written (Up rows), and with cuDNN's
   TF32 flag at PyTorch's default (the apps'), restored afterwards; every
   batch through the C++ augment (its call count exactly); before it,
   native_augment: the trainer's C++ host augment (vfidkr_torch.data.native)
   built with g++, its batches bit for bit equal to the Python path at B=3
   and 12 (the 18 triplets, 288x512 frames with random crop offsets, the
   swap and each flip forced), both paths' host ms a batch (median of 20)
   and its thread count;
5g. depth: the depth-eval core (vfidkr_torch.apps.depth_eval.evaluate_depth)
   at 256x320 on two samples with depths and SDR pairs, MegaDepth from
   seed 0, on the card and on the CPU: si-RMSE within rtol 1e-4, the SDR
   counts equal;
5h. spatial_ops: the row-sharded op chains (vfidkr_torch.parallel.spatial)
   at the video's padded 1x.x768x1344, 4 shards of the one card (a thread
   and stream a shard), halo 32, make_flow with |fy| bounded to 28 px and
   a zero-motion island across the shard edges: flow_project(hole_fill) ->
   filter_interpolate at C = 3 (K2, K3, K1) and depth_flow_project(
   hole_fill) -> the 196-channel warp (K2 weighted, K3, K7); each chain's
   offsets held to its unsharded run on the card and its frame to the
   unsharded warp of those offsets (ATOL), each of its launches to its
   plain version on the same block and frame arguments (row0 < 0 on the
   first shard; K3 bit for bit, with its interior rows and carries), the
   launches exactly (4 of each a chain), and both chains' host wall times
   sharded and not;
5i. spatial_video: the video driver's sharded forward of DAINSlowMotion(0.25)
   on the video phase's clip, 2 shards of the one card, halo 64, frames
   padded by the sharded rule to 1408x768: launches exactly (2 x 3 pairs x
   phase 4's), frames finite, frames/s sharded and not, peak memory in all
   and a shard's (the forward on one shard's 1408x512 block alone), and
   each frame's PSNR against the unsharded forward (reported, not bounded:
   the tiled forward is JAX's approximation);
5j. data_parallel: the trainer's data-parallel path (vfidkr_torch.parallel.
   mesh) in a world-size-1 NCCL group made in this process (a file store),
   3 DAIN train steps at B=3 256x448 against the one-process steps on the
   same weights and batches (losses, the last gradients and the parameters
   per leaf); with two or more cards, world size 2 as well;
5k. dormant_ops: the reference's dormant ops, plain PyTorch on every device
   (the deformable filter interpolation, static and deformed, and without
   the filter; interpolate_bilinear; min_depth_flow_project with and without
   the hole fill; separable_conv and separable_conv_flow on the 16-tap
   valid grid) at 2x3x256x448 on the card and the CPU: each forward within
   ATOL x max(1, |CPU|) (the z-buffer bit for bit), each differentiable
   input's gradient within ATOL x max(1, max |CPU|), no kernel of the port
   launched (PATHS["dormant_ops"]), each op's ms a call;
5l. vestigial: DAIN(init_unused=True), phase 3's model, launches K1-K3 once
   in one eval forward and equals DAIN(init_unused=False) with the shared
   weights bit for bit (run_to_run_stable); its reference-layout state dict
   reloads with strict=True; a train step leaves its three vestigial
   children unchanged;
5m. png_depths: four 1280x720 PNGs written by hand (16-bit RGB, 16-bit
   gray, Adam7 8-bit RGB, 4-bit palette) read back by read_rgb exactly, each
   read's host ms; the depth-eval CLI on the card on a 16-bit Adam7 PNG with
   an .sdr.npz sample through the numpy resize (no PIL on the machine);
5n. sepconv: SepConv (ModelConfig("SepConv"), the SepConv cell's weights
   from benchmark/configs/sepconv.json, seed 0): its forward on the card
   held to the CPU at 192x128; the video driver's to_input and
   frames_between on a 1920x1080 clip run at 1984x1152 (padded): K9
   (sepconv_pair) once a pair and no other kernel of the port
   (PATHS["sepconv_video"]), (1, 1080, 1920, 3) uint8 frames,
   the pairs' host time; then K9 against its plain version in float64 at
   (1,3,1152,1984) and at the ragged (2,3,37,75), each value within K9_TOL
   of the float64 sum of its terms' magnitudes, two launches bit for bit,
   and its time a call (CUDA events), its plain version's and its bound
   (benchmark/lib/local_conv.bound_s); cuDNN's autotuner flag, which the
   model's build turns on, restored after;
5o. dense_conv: K10, PWC-Net's dense-block convs, once a conv in a DAIN
   forward (25 launches, PATHS["eval_forward"]); then at levels 2 and 3
   of cells 1 and 4 (a 512x320 pair), 2 (1344x768), 3 (B = 3 at 256x448,
   both directions: batch 6) and level 2 of cell 5 (batch 80): the level's
   five convs through its buffer, each against float64 within DENSE_TOL of
   the sum of |x||w| + |b| on the input it read, the level twice bit for
   bit, and timed by CUDA events (median of 20 runs of 5 levels) beside its
   bound (benchmark/lib/flow_dense.conv_work), the plain version (cuDNN's
   leaky_relu(conv2d) and torch.cat, as the port ran before, cudnn.benchmark
   off) and the same with cudnn.benchmark on (library_ms, never called by
   the port); a level where K10 is not the fastest is printed as such;
6. kernels: each kernel against its plain PyTorch version on the card, at
   the paths' shapes (2 x 256 x 448; the context warp at 196 channels; the
   projection also depth-weighted; K4 at (1,128,256,448), (1,128,512,704)
   and (3,128,320,448), and checked at the ragged (2,128,37,75); K8, the
   float32 rectifier head, at the cells' (1,45,320,512) and (1,437,768,1344),
   against float64 and launched twice bit for bit), with the
   tolerance stated; K7 also on the paths' near-uniform move, across a sharp
   flow discontinuity, at C = 9, 37 and 200 and at the ragged 37x75 and
   37x76, each with the number of its tiles that took the direct gather; K1
   also on the paths' move, on the warp's exact bounds and at ragged
   widths (at the slow-motion train step's N = 6, back-to-back launches
   would keep part of its 66 MB in the 50 MB L2, so its time there is
   phase 7's, inside the path); K2, plain and
   depth-weighted, also on the paths' move (and at N = 6), a converging
   flow, a jump whose tiles take the direct adds, landings on the last
   column and row and ragged frames, each with the number of its tiles that
   took the direct adds (the hit count equal bit for bit), its yardstick one
   index_add_ over the 4 N H W targets built beforehand; K3
   also on a full-height edge band, runs of holes across word boundaries, an
   all-hole field and at (1,3,512,704), each held to equality; the backward kernels
   against the autograd of the plain forwards, and the depth projection's
   backward against its plain version (the reference's, not autodiff) on
   the depth-weighted case, with and without the depth gradient, and on a
   flow landing on the last row and column; K6, both uses (the depth
   projection's without the depth gradient, as the slow-motion train step
   runs it), also at the train steps' N = 6 on three draws of make_flow and
   on the paths' move and on a jump, one case of each launched twice and
   equal bit for bit, its yardstick one embedding_bag over each
   pixel's four cells (for the depth projection, over the prebuilt field:
   the four-cell sum only); each case's time per call
   with the wrapper and its plain version's (CUDA events), K4's also beside
   its yardstick, the same six convs as bf16 cuDNN calls, K8's beside
   cuDNN's float32 relu(conv2d) with cudnn.benchmark on (its plain version
   is the same call with it off), K2's beside
   index_add_, each yardstick's also on the device; and its bound: the
   larger of its bytes (each input read once, each output written once) at
   3.35 TB/s and its operations at 67 TFLOP/s float32 (989 TFLOP/s bf16
   for K4); then, compared only, K1, K7, the weighted K2, K3 and K4 at the
   video phase's 1344x768;
7. profile: where the slow-motion forward's, the two train steps' and the
   bf16 lane's time goes (each stage alone, the Adamax step, torch.profiler
   over whole runs: busy share, the largest device kernels), and each kernel
   case's (and its yardstick's) device time per call; then
   vfidkr_torch.utils.trace around one DAIN eval forward, whose Chrome trace
   must hold K1-K3's device events;
8. one JSON line of the kernels, with each kernel's launches in one run of
   each path (K9's row from phase 5n), then the result line.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.apps import demo_middlebury, interpolate_video
from vfidkr_torch.apps import train as train_app
from vfidkr_torch import ops as OPS
from vfidkr_torch.apps import depth_eval
from vfidkr_torch.apps.depth_eval import evaluate_depth
from vfidkr_torch.config import ModelConfig
from vfidkr_torch.convert import reference_state_dict
from vfidkr_torch.data import native, synthetic, vimeo90k
from vfidkr_torch.kernels import build
from vfidkr_torch.models import DAIN, DAINSlowMotion
from vfidkr_torch.models.dain import DIV_FLOW, TIMESTEP, VESTIGIAL
from vfidkr_torch.models.layers import upsample_bilinear
from vfidkr_torch.models.megadepth import (MegaDepthHourglass,
                                           depth_inv_from_log_depth)
from vfidkr_torch.ops import conv_head as CH
from vfidkr_torch.ops import dense_conv as DC
from vfidkr_torch.ops import filter_interpolation as FI
from vfidkr_torch.ops import flow_projection as FP
from vfidkr_torch.ops import rectify as RB
from vfidkr_torch.training import (TrainConfig, eval_step, make_optimizer,
                                   train_step)
from vfidkr_torch.training.lr_schedule import PlateauState, plateau_step
from vfidkr_torch.training.train_state import FROZEN, GROUPS
from vfidkr_torch.utils import pad_to_multiple, unpad
from vfidkr_torch.utils.image_io import (ZLIB_LEVEL, read_png, read_rgb,
                                         write_png)

# the module (``vfidkr_torch.ops`` exports its function of the same name)
SC = importlib.import_module("vfidkr_torch.ops.separable_conv")

# the flows and hole layouts that reach K7's and K3's branches, shared with
# the card-only tests
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
import torch_geometry as geo  # noqa: E402
import torch_png  # noqa: E402

# the SepConv cell's configuration and weights, and K9's bound
sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchmark.lib.cell import load_json  # noqa: E402
from benchmark.lib.flow_dense import DENSE, OD, conv_work  # noqa: E402
from benchmark.lib.local_conv import bound_s  # noqa: E402
from benchmark.lib.weights import make_state, shapes_of  # noqa: E402

N, H, W = 2, 256, 448           # both directions of one 448x256 frame pair
C_CTX = 196                     # DAIN_slowmotion's context: S2DF + log-depth
ATOL = 1e-5                     # kernel vs plain, see _compare
TRAIN_B = 3                     # the reference's training batch
TRAIN_STEPS = 5
CPU_B = 1                       # batch of the GPU-against-CPU train step
SLOWMO_T = 0.25                 # 4x slow motion: 3 frames a pair
TRAIN_T = 0.5                   # JAX's trainer: one frame a triplet
CPU_HW = 128                    # frame of the GPU-against-CPU slow-motion step
HBM_BYTES_S = 3.35e12           # H100 SXM HBM3
F32_FLOP_S = 67e12              # H100 SXM float32, CUDA cores
BF16_FLOP_S = 989e12            # H100 SXM bf16, tensor cores, dense
# K4's shapes: the DAIN eval trunk, the padded Middlebury 640x480 frame, and
# a batch of three at the padded Vimeo-90K width; and a ragged one (tiles cut
# at the frame's edge on both axes), checked per launch and per call only
K4_SHAPES = ((1, 128, H, W), (1, 128, 512, 704), (3, 128, 320, 448))
K4_RAGGED = (2, 128, 37, 75)
K4_TOL = 2.0 ** -6              # two bf16 ulps, see _compare_k4
# K8's shapes: DAIN's head at cell 1's 512x320 and the slow-motion head at
# 1344x768; its tolerance, see _compare_k8
K8_SHAPES = ((1, 45, 320, 512), (1, 437, 768, 1344))
K8_TOL = 2e-6
# The bf16 lane against the float32 lane on the rectified frame.  JAX's own
# lane is max 0.035, mean 0.0076, 40.3 dB off its float32 forward at 64x64
# on these tamed weights (tests/torch_lane.py); allowed here: 2.5x its
# mean, 7x its max (28x the pixels at 448x256) and 8 dB under its PSNR.
LANE_MEAN, LANE_MAX, LANE_PSNR = 0.02, 0.25, 32.0
MB_H, MB_W, MB_PAIRS = 480, 640, 3     # the Middlebury phase's frames
# the video phase: a 4-frame 1280x720 clip from PNG files, 3 pairs, run at
# 1344x768 (padded to a multiple of 128, at least 32 px a side)
VIDEO_H, VIDEO_W, VIDEO_FRAMES = 720, 1280, 4
VIDEO_PAIRS = VIDEO_FRAMES - 1
VIDEO_PADDED = (768, 1344)
# a synthesised PNG against the same model run in memory: float32 within 1
# level, bf16 within 8, at most 0.5 % of the values differing.  The forward
# changes from run to run where sums run in any order: cuDNN's algorithm for
# PWC-Net's transposed convolutions and K2's float atomics
# (tools/bf16_determinism.py); a flipped last bit there flips bf16
# roundings in the rectifier (bf16: 5-6 levels on 0.23-0.24 % of the
# values measured)
VIDEO_LEVELS = {"float32": 1, "bfloat16": 8}
VIDEO_SHARE = 0.005
# the train_from_disk phase: tools/run_plateau_resume.sh's 18 triplets
# (12 train, 6 test) at 256x448, B=3, 4 steps an epoch, 2 epochs then a
# resume to 3; patience 1, factor 0.2
DISK_TRIPLETS, DISK_STEPS, DISK_PATIENCE, DISK_FACTOR = 18, 4, 1, 0.2
# its ms/step readings: 2 epochs of 10 steps, the second the reading (the
# first holds the fresh trainer's set-up)
DISK_READ_STEPS = 10
DISK_HW = (H, W)
# the native_augment phase: batches of the trainer's B and of 12, on the 18
# triplets at the crop's size and on frames larger than the crop (random
# crop offsets); its host times the median of 20 batches
AUG_BATCHES, AUG_LARGE_HW, AUG_REPS = (TRAIN_B, 12), (288, 512), 20
DEPTH_HW, DEPTH_SDR_PAIRS = (256, 320), 200   # the depth phase's samples
# the row-sharded phases: the op chains at the video's padded frame in 4
# shards of 192 rows with halo 32 (256 rows a block), |fy| bounded to 28 px;
# the video's sharded forward in 2 shards with the driver's halo, 64
SPATIAL_SHARDS, SPATIAL_HALO, SPATIAL_REACH = 4, 32, 28.0
VIDEO_SHARDS, VIDEO_HALO = 2, 64
DP_STEPS = 3                    # the data-parallel phase's train steps
# the dormant_ops phase: the deformable ops' offsets reach +-1.5 px; the
# separable ops' filters have 16 taps (output grid (H-15) x (W-15)); the
# z-buffer's inverse depth is 1 + k/256 for k < 8, so colliding sources tie
DORMANT_OFFSET, SEP_TAPS, DEPTH_LEVELS = 1.5, 16, 8
# the sepconv phase: the cell's 1920x1080 clip, run at 1984x1152 after the
# driver's padding, 3 pairs; the card against the CPU at 192x128 (outputs
# near 0.5, float32 both, convs in other orders and algorithms); K9 at the
# path's shape and at a ragged one, its error over the float64 sum of its
# terms' magnitudes (float32 sums in another order read below 1e-6)
SEPCONV_HW, SEPCONV_PADDED, SEPCONV_PAIRS = (1080, 1920), (1152, 1984), 3
SEPCONV_CPU_HW, SEPCONV_CPU_ATOL = (128, 192), 1e-4
K9_SHAPES = ((1, 1152, 1984), (2, 37, 75))
K9_TOL = 2e-6
# the dense_conv phase: (cell, batch, level, map) of PWC-Net's decode (both
# directions of the cell's batch, the padded frame at 1/2^level); K10's
# tolerance as K8's (float32 sums in another order read 1.4-4.7e-7)
DENSE_SHAPES = (("cells 1, 4", 2, 2, (80, 128)), ("cells 1, 4", 2, 3, (40, 64)),
                ("cell 2", 2, 2, (192, 336)), ("cell 2", 2, 3, (96, 168)),
                ("cell 3", 6, 2, (64, 112)), ("cell 3", 6, 3, (32, 56)),
                ("cell 5", 80, 2, (64, 112)))
DENSE_TOL = 2e-6

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
    "filter_interpolate_ctx": (
        "vfidkr_torch/csrc/filter_interpolate_ctx.cu",
        "vfidkr_tpu/ops/pallas/ctx_gather_kernel.py:160"),
    "fused_resblocks": (
        "vfidkr_torch/csrc/fused_resblocks.cu",
        "vfidkr_tpu/ops/pallas/rectify_kernel.py:135"),
    # the C = 3 use of scatter4_bwd_pallas, by _dfp_bwd
    "depth_flow_project_bwd": (
        "vfidkr_torch/csrc/flow_project_scatter_bwd.cu",
        "vfidkr_tpu/ops/pallas/projection_band_kernel.py:227"),
}
# launches of each kernel of kernels.LAUNCHES in one run of each path; the
# others launch none.  PWC-Net launches K10 once a dense conv, 25 times a
# forward (both directions in one batch); the float32 rectifier launches K8
# once a call (one a DAIN forward, one a frame of a slow-motion forward),
# the bf16 lane none.
PATHS = {
    "eval_forward": {"filter_interpolate_fwd": 1, "flow_project_scatter": 1,
                     "flow_project_finalize": 1, "rectify_head": 1,
                     "dense_conv": 25},
    "train_step": {"filter_interpolate_fwd": 1, "flow_project_scatter": 1,
                   "filter_interpolate_bwd": 1,
                   "flow_project_scatter_bwd": 1, "rectify_head": 1,
                   "dense_conv": 25},
    "slowmo_forward": {"filter_interpolate_fwd": 3,
                       "filter_interpolate_ctx": 3,
                       "flow_project_scatter": 3,
                       "flow_project_finalize": 3, "rectify_head": 3,
                       "dense_conv": 25},
    # the bf16 lane: K4 launches once per conv of the trunk, six a call
    "eval_forward_bf16": {"filter_interpolate_fwd": 1,
                          "flow_project_scatter": 1,
                          "flow_project_finalize": 1, "fused_resblocks": 6,
                          "dense_conv": 25},
    "slowmo_forward_bf16": {"filter_interpolate_fwd": 3,
                            "filter_interpolate_ctx": 3,
                            "flow_project_scatter": 3,
                            "flow_project_finalize": 3,
                            "fused_resblocks": 18, "dense_conv": 25},
    "middlebury_bf16": {"filter_interpolate_fwd": MB_PAIRS,
                        "flow_project_scatter": MB_PAIRS,
                        "flow_project_finalize": MB_PAIRS,
                        "fused_resblocks": 6 * MB_PAIRS,
                        "dense_conv": 25 * MB_PAIRS},
    # the context warp forward only: its flow and filter are detached and
    # the context nets frozen
    "slowmo_train_step": {"filter_interpolate_fwd": 1,
                          "filter_interpolate_ctx": 1,
                          "flow_project_scatter": 1,
                          "filter_interpolate_bwd": 1,
                          "depth_flow_project_bwd": 1, "rectify_head": 1,
                          "dense_conv": 25},
}
# the video driver over VIDEO_PAIRS pairs, each a slow-motion forward, in
# each lane
PATHS["video_slowmo"] = {k: VIDEO_PAIRS * n
                         for k, n in PATHS["slowmo_forward"].items()}
PATHS["video_slowmo_bf16"] = {k: VIDEO_PAIRS * n
                              for k, n in PATHS["slowmo_forward_bf16"].items()}
# the two sharded op chains: K2, K3 once a shard each, K1 and K7 one chain
# each
PATHS["spatial_ops"] = {"flow_project_scatter": 2 * SPATIAL_SHARDS,
                        "flow_project_finalize": 2 * SPATIAL_SHARDS,
                        "filter_interpolate_fwd": SPATIAL_SHARDS,
                        "filter_interpolate_ctx": SPATIAL_SHARDS}
# the sharded slow-motion forward: each shard runs the whole network
PATHS["spatial_video"] = {k: VIDEO_PAIRS * VIDEO_SHARDS * n
                          for k, n in PATHS["slowmo_forward"].items()}
PATHS["data_parallel"] = {k: DP_STEPS * n
                          for k, n in PATHS["train_step"].items()}
# the reference's dormant ops are plain PyTorch: no kernel of the port
# launches; the vestigial phase's DAIN(init_unused=True) eval forward is
# phase 3's
PATHS["dormant_ops"] = {}
PATHS["vestigial_eval"] = dict(PATHS["eval_forward"])
# SepConv's path launches K9 alone, once a pair
PATHS["sepconv_video"] = {"sepconv_pair": SEPCONV_PAIRS}
# checked, not a column of the kernels line
SLOWMO_EVAL_STEP = {"filter_interpolate_fwd": 1, "filter_interpolate_ctx": 1,
                    "flow_project_scatter": 1, "flow_project_finalize": 1,
                    "rectify_head": 1, "dense_conv": 25}
# the case of each kernel that its row of the kernels line reports
ROW_CASE = {"filter_interpolate_fwd": "K1 C=3",
            "flow_project_scatter": "K2 depth-weighted",
            "flow_project_finalize": "K3",
            "filter_interpolate_bwd": "K5 C=3 no image grad",
            "flow_project_scatter_bwd": "K6",
            "filter_interpolate_ctx": "K7 C=196",
            "fused_resblocks": f"K4 {(1, 128, H, W)}",
            "depth_flow_project_bwd": "K6 C=3 (depth) no depth grad"}


def card_label(smi: str | None = None) -> str:
    """The card's name and power limit as nvidia-smi gives them, the label
    of every time the newer phases print."""
    if smi is None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[0]


TF32_DEFAULTS: dict = {}         # PyTorch's, read before phase 1 turns TF32 off


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA "
                           "GPU and has no CPU fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print("[device] nvidia-smi name, power.limit:")
    print(card_label(smi))
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    TF32_DEFAULTS.update(cudnn=torch.backends.cudnn.allow_tf32,
                         matmul=torch.backends.cuda.matmul.allow_tf32)
    print(f"[device] TF32 defaults: cudnn.allow_tf32="
          f"{TF32_DEFAULTS['cudnn']}, cuda.matmul.allow_tf32="
          f"{TF32_DEFAULTS['matmul']}")
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


def _compare_k3(name, got, want) -> float:
    """K3 against its plain version: equal bit for bit is expected (the same
    IEEE divisions, the neighbours summed in the same order); where a case
    is not, it says so and is held to ATOL * max(1, |plain|) instead."""
    if torch.equal(got, want):
        print(f"[kernels] {name}: equal to the plain version, bit for bit")
        return 0.0
    print(f"[kernels] {name}: NOT bit-equal, {(got != want).sum().item()} "
          f"values differ; held to the {ATOL:.0e} bound instead")
    return _compare(name, got, want)


def make_flow(g: torch.Generator, n: int = N, h: int = H, w: int = W
              ) -> torch.Tensor:
    """A smooth random flow up to +-24 px (slopes under 0.5, so the
    projection folds little), about 5% of pixels pushed out of the frame, and
    the exact-border cases of both kernels' bounds; (n >= 2, 2, h, w)."""
    coarse = (torch.rand(n, 2, 3, 5, generator=g) * 2 - 1) * 24
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=True)
    out = torch.rand(n, h, w, generator=g) < 0.05
    side = torch.where(torch.rand(n, h, w, generator=g) < 0.5, -1.0, 1.0)
    flow[:, 0] = torch.where(out, flow[:, 0] + side * (w + 16), flow[:, 0])
    flow[0, :, 20:40, w - 8] = torch.tensor([7.0, 0.0])[:, None]   # x2 == W-1
    flow[0, :, h - 6, 100:140] = torch.tensor([0.0, 5.0])[:, None]  # y2 == H-1
    flow[1, :, 30:40, 0] = torch.tensor([w / 2, 0.0])[:, None]     # |fx| == W/2
    flow[1, :, 40:50, 0] = torch.tensor([w / 2 - 0.5, 0.0])[:, None]
    flow[1, :, 50:60, 10] = torch.tensor([0.0, h / 2])[:, None]    # |fy| == H/2
    return flow


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _landings(flow, filter_bounds):
    """Count of pixels whose landing is valid for the warp (with its
    |f| < size/2 terms) or for the projection."""
    h, w = flow.shape[-2:]
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = torch.arange(w, device=flow.device) + fx
    y2 = torch.arange(h, device=flow.device).view(h, 1) + fy
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    if filter_bounds:
        valid &= (fx.abs() < w / 2) & (fy.abs() < h / 2)
    return int(valid.sum().item())


def _k1_direct(image, flow, filt):
    """K1 launched at any C, past the wrapper's dispatch to K7 above 8
    channels: to time K1 on the context tensors."""
    out = torch.empty_like(image)
    kernels.launch("filter_interpolate_fwd", image, flow, filt, out,
                   *image.shape, 0, image.shape[2])
    return out


def _grad_call(fn, ins, cot):
    """A backward call: autograd.grad through ``fn``'s graph on ``ins``
    (the tensors that need a gradient are the leaves)."""
    out = fn(*ins)
    leaves = [x for x in ins if x.requires_grad]
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version.  Returns the cases that
    phase_call_times and phase_device_times time: kernel, the kernel and
    plain calls, the error, and the bytes and operations the work needs."""
    g = torch.Generator().manual_seed(0)
    flow = make_flow(g).to(dev)
    image = torch.rand(N, 3, H, W, generator=g).to(dev)
    filt = torch.randn(N, 16, H, W, generator=g).to(dev)
    ctx = torch.rand(N, C_CTX, H, W, generator=g).to(dev)
    depth_inv = (1e-6 + torch.exp(-(torch.rand(N, H, W, generator=g) * 4
                                    - 1))).to(dev)
    warp_px = _landings(flow, True)
    cases = {}

    def case(key, kernel, fn, plain, err, nbytes, ops, peak=F32_FLOP_S,
             library=None, library_name=None, per_call=1):
        cases[key] = {"kernel": kernel, "fn": fn, "plain": plain, "err": err,
                      "bytes": nbytes, "ops": ops, "peak": peak,
                      "library": library, "library_name": library_name,
                      "per_call": per_call}

    # the warp: K1 on the frames; K7, and K1 for comparison, on the context;
    # K7 also on the paths' near-uniform move, across a sharp discontinuity
    # (tiles past its staging box), at other channel counts and at a ragged
    # frame (partial tiles and channel chunks)
    rng = np.random.RandomState(0)
    rags = [(2, 37, 75), (2, 37, 76)]   # W % 4: 4- and 16-byte accesses
    uniform = _t(geo.smooth_flow(rng, N, H, W, 0.5, (5.3, -3.1)), dev)
    # K2 at the slow-motion train step's N = 6: both directions of 3 pairs
    uniform6 = _t(geo.smooth_flow(rng, 3 * N, H, W, 0.5, (5.3, -3.1)), dev)
    warps = [("K1 C=3", image, flow, filt), ("K7 C=196", ctx, flow, filt),
             ("K1 C=196", ctx, flow, filt),
             ("K1 C=3 near-uniform", image, uniform, filt),
             ("K1 C=3 edge flows", image,
              _t(geo.warp_edge_flow(rng, N, H, W), dev), filt),
             ("K7 C=196 near-uniform", ctx, uniform, filt),
             ("K7 C=196 discontinuity", ctx,
              _t(geo.discontinuous_flow(rng, N, H, W), dev), filt)]
    warps += [(f"K7 C={c}", torch.rand(N, c, H, W, generator=g).to(dev),
               flow, filt) for c in (9, 37, 200)]
    for rag in rags:
        flow_rag = _t(geo.smooth_flow(rng, *rag, 8.0), dev)
        filt_rag = torch.randn(rag[0], 16, *rag[1:], generator=g).to(dev)
        warps += [(f"K{1 if c <= FI.MAX_NARROW_C else 7} C={c} {rag}",
                   torch.rand(rag[0], c, *rag[1:], generator=g).to(dev),
                   flow_rag, filt_rag) for c in (1, 3, 8, 9, C_CTX)]
    for key, img, fl, fi in warps:
        kernel = ("filter_interpolate_fwd" if key.startswith("K1")
                  else "filter_interpolate_ctx")
        fn = _k1_direct if key == "K1 C=196" else FI.filter_interpolate
        if key != "K1 C=196" and FI.forward_kernel(img.shape[1]) != kernel:
            raise AssertionError(f"{key}: the wrapper dispatches to "
                                 f"{FI.forward_kernel(img.shape[1])}")
        args = (img, fl, fi)
        err = _compare(f"{kernel} {key} at {tuple(img.shape)}", fn(*args),
                       FI.filter_interpolate_plain(*args))
        # 16 weights of 3 multiplies, then 16 multiply-adds per channel
        case(key, kernel, lambda fn=fn, a=args: fn(*a),
             lambda a=args: FI.filter_interpolate_plain(*a), err,
             _nbytes(img, fl, fi, img),
             _landings(fl, True) * (48 + 32 * img.shape[1]))
        if kernel == "filter_interpolate_ctx":
            n, _, h, w = img.shape
            tiles = n * math.ceil(h / 8) * math.ceil(w / 32)
            _, direct = FI.filter_interpolate_ctx_counted(*args)
            cases[key]["direct_tiles"] = direct
            print(f"[kernels] {key}: {direct} of {tiles} 8x32 tiles took "
                  f"the direct gather, the others staged their windows")
            if key.endswith("discontinuity") and direct == 0:
                raise AssertionError(f"{key}: no tile took the direct "
                                     f"gather")
    # K1 at the train steps' N = 6 (the batch on the grid's z up to 5), on
    # three draws of make_flow and on the paths' move: compared, not timed
    # (the in-path profiles time it at this shape)
    image6 = torch.rand(3 * N, 3, H, W, generator=g).to(dev)
    filt6 = torch.randn(3 * N, 16, H, W, generator=g).to(dev)
    flow6 = torch.cat([make_flow(g) for _ in range(3)]).to(dev)
    for label, fl in (("make_flow x3", flow6), ("near-uniform", uniform6)):
        _compare(f"filter_interpolate_fwd K1 C=3 N=6 {label} at "
                 f"{tuple(image6.shape)}",
                 FI.filter_interpolate(image6, fl, filt6),
                 FI.filter_interpolate_plain(image6, fl, filt6))

    # the projection: K2, plain and depth-weighted, on make_flow, the paths'
    # move (also at N = 6), a converging flow (several sources a cell), a
    # jump (tiles past the shared-memory box: direct adds), landings on the
    # last column and row (the double add) and ragged frames; then K3
    print(f"[kernels] depth_inv in [{depth_inv.min().item():.4f}, "
          f"{depth_inv.max().item():.4f}] (1e-6 + exp(-U(-1, 3)))")
    scatters = [("K2", flow, None), ("K2 depth-weighted", flow, depth_inv)]
    for label, fl in (
            ("near-uniform", uniform), ("N=6 near-uniform", uniform6),
            ("converging", _t(geo.converging_flow(N, H, W, 0.75), dev)),
            ("jump", _t(geo.scatter_jump_flow(rng, N, H, W), dev)),
            ("border landings", _t(geo.border_landing_flow(rng, N, H, W), dev)),
            *((str(rag), _t(geo.smooth_flow(rng, *rag, 8.0), dev))
              for rag in rags)):
        n, _, h, w = fl.shape
        scatters += [(f"K2 {label}", fl, None),
                     (f"K2 depth-weighted {label}", fl,
                      _t(geo.depth_weight(rng, n, h, w), dev))]
    for key, fl, wt in scatters:
        got, err, direct = _compare_scatter(key, fl, wt)
        weights = () if wt is None else (wt,)
        # reads the flow (and weight), writes the sums; 12 adds a landing,
        # and 3 multiplies by the weight
        case(key, "flow_project_scatter", lambda f=fl, d=wt: FP.scatter4(f, d),
             lambda f=fl, d=wt: FP.scatter4_plain(f, d), err,
             _nbytes(fl, *weights, got),
             _landings(fl, False) * (12 if wt is None else 15),
             **({"library": index_add_call(fl, wt),
                 "library_name": "one index_add_"}
                if key in ("K2", "K2 depth-weighted") else {}))
        cases[key]["direct_tiles"] = direct
    acc_k = FP.scatter4(flow)
    acc_p = FP.scatter4_plain(flow)

    holes = (acc_k[:, 2] <= 0).float().mean().item()
    fin_k = FP.finalize(acc_k)
    err = _compare_k3(f"flow_project_finalize ({holes:.2%} holes)", fin_k,
                      FP.finalize_plain(acc_k))
    _compare("flow_project, both kernels vs the plain chain", fin_k,
             FP.finalize_plain(acc_p))
    case("K3", "flow_project_finalize", lambda: FP.finalize(acc_k),
         lambda: FP.finalize_plain(acc_k), err, _nbytes(acc_k, fin_k),
         acc_k[:, 2].numel() * 2)

    wacc_k = FP.scatter4(flow, depth_inv)
    wacc_p = FP.scatter4_plain(flow, depth_inv)
    wfin_k = FP.finalize(wacc_k)
    err = _compare_k3("flow_project_finalize on the weighted sums", wfin_k,
                      FP.finalize_plain(wacc_k))
    case("K3 depth-weighted", "flow_project_finalize",
         lambda: FP.finalize(wacc_k), lambda: FP.finalize_plain(wacc_k), err,
         _nbytes(wacc_k, wfin_k), wacc_k[:, 2].numel() * 2)
    _compare("depth_flow_project, both kernels vs the plain chain",
             FP.depth_flow_project(flow, depth_inv, hole_fill=True),
             FP.finalize_plain(wacc_p))

    # K3 on hole layouts: a full-height band of empty columns at the left
    # edge (a uniform 24 px move), runs across word boundaries, no filled
    # cell at all, and the Middlebury frame (704x512) under the paths' move
    band = FP.scatter4(_t(geo.edge_band_flow(N, H, W), dev))
    if not (band[:, 2, :, :24] <= 0).all():
        raise AssertionError("the edge band's columns 0-23 are not empty")
    for key, a in (("K3 edge band", band),
                   ("K3 word-crossing runs",
                    _t(geo.word_crossing_sums(rng, N, H, W), dev)),
                   ("K3 all holes", torch.zeros(N, 3, H, W, device=dev)),
                   ("K3 (1,3,512,704)", FP.scatter4(_t(geo.smooth_flow(
                       rng, 1, 512, 704, 0.5, (5.3, -3.1)), dev)))):
        holes = (a[:, 2] <= 0).float().mean().item()
        got = FP.finalize(a)
        err = _compare_k3(f"flow_project_finalize, {key[3:]} "
                          f"({holes:.2%} holes)", got, FP.finalize_plain(a))
        if key == "K3 all holes" and torch.count_nonzero(got).item():
            raise AssertionError("the all-hole field did not fill with 0")
        case(key, "flow_project_finalize", lambda a=a: FP.finalize(a),
             lambda a=a: FP.finalize_plain(a), err, _nbytes(a, got),
             a[:, 2].numel() * 2)

    # the backward kernels
    cot = torch.randn(N, 3, H, W, generator=g).to(dev)
    fi_k = _grads(FI.filter_interpolate, (image, flow, filt), cot)
    fi_p = _grads(FI.filter_interpolate_plain, (image, flow, filt), cot)
    err = max(_compare_grad(f"filter_interpolate_bwd grad->{name}", a, b)
              for name, a, b in zip(("image", "flow", "filt"), fi_k, fi_p))
    for need_image in (False, True):
        ins = [image.clone().requires_grad_(need_image),
               flow.clone().requires_grad_(), filt.clone().requires_grad_()]
        grads = (image,) if need_image else ()
        # reads image, flow, filt and the cotangent; writes the gradients
        case(f"K5 C=3 {'with' if need_image else 'no'} image grad",
             "filter_interpolate_bwd",
             _grad_call(FI.filter_interpolate, ins, cot),
             _grad_call(FI.filter_interpolate_plain, ins, cot), err,
             _nbytes(image, flow, filt, cot, flow, filt, *grads),
             warp_px * (100 + 64 * image.shape[1]))

    out_cot = torch.randn(N, 2, H, W, generator=g).to(dev)
    fp_k = _grads(lambda f: FP.flow_project(f, hole_fill=False), (flow,),
                  out_cot)
    fp_p = _grads(lambda f: FP._count_average(FP.scatter4_plain(f)),
                  (flow,), out_cot)
    _compare_grad(
        "flow_project_scatter_bwd (flow_project(hole_fill=False) grad->flow)",
        fp_k[0], fp_p[0])
    acc_cot = torch.randn(N, 3, H, W, generator=g).to(dev)
    # K6 in both uses: N = 2 on make_flow (the kernels line's rows), and at
    # the train steps' N = 6 on three draws of make_flow and on the paths'
    # move, a jump (landings 44 px off on one side of a line) and the
    # border; the new draws from their own seeds, so the other cases'
    # inputs stay
    g6, rng6 = torch.Generator().manual_seed(6), np.random.RandomState(6)
    jump = _t(geo.scatter_jump_flow(rng6, N, H, W), dev)
    border = torch.zeros(N, 2, H, W, device=dev)
    border[:, 1] = 2.25
    border[:, 1, H - 1] = 0.0
    border[:, 0, :, W - 1] = 0.0
    border[1, 0, 3, W - 2] = 1.0
    inputs = [("", flow, acc_cot, depth_inv, out_cot)]
    for label, fl in (("N=6 make_flow x3", flow6), ("N=6 near-uniform", uniform6),
                      ("jump", jump), ("border", border)):
        n = fl.shape[0]
        inputs.append((f" {label}", fl,
                       torch.randn(n, 3, H, W, generator=g6).to(dev),
                       _t(geo.depth_weight(rng6, n, H, W), dev),
                       torch.randn(n, 2, H, W, generator=g6).to(dev)))
    for label, fl, cot3, dep, cot2 in inputs:
        if label != " border":
            _scatter_bwd_case(case, label, fl, cot3)
        _depth_bwd_cases(case, label, fl, dep, cot2)

    # the bf16 lane's rectifier trunk: six launches a call; its yardstick is
    # the same six convs as bf16 cuDNN calls on channels-last tensors, the
    # layout the kernel takes.  The wrapper is timed on an NCHW input, as
    # block1 leaves it on the paths: its NCHW -> NHWC copy and the weight
    # packing count in its time a call.
    _compare_k4(K4_RAGGED, *(t.to(dev) for t in _trunk_inputs(g, K4_RAGGED)))
    for shape in K4_SHAPES:
        x, w6 = (t.to(dev) for t in _trunk_inputs(g, shape))
        err = _compare_k4(shape, x, w6)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        n, c, h, w = shape
        case(f"K4 {shape}", "fused_resblocks",
             lambda x=x, w6=w6: RB.fused_resblocks(x, w6),
             lambda x=x, w6=w6: RB.fused_resblocks_plain(x, w6), err,
             2 * _nbytes(x) + _nbytes(w6), RB.N_CONVS * 2 * c * c * 9 * n * h * w,
             peak=BF16_FLOP_S, per_call=RB.N_CONVS,
             library=lambda x=x_cl, w6=w6: cudnn_chain(x, w6),
             library_name="the bf16 cuDNN chain")

    # the float32 lane's rectifier head, K8: its plain version on the card
    # is cuDNN's float32 relu(conv2d) as the model ran it before (benchmark
    # off); the yardstick the same call with cudnn.benchmark on
    for shape in K8_SHAPES:
        x, wt, b = (t.to(dev) for t in _head_inputs(g, shape))
        err = _compare_k8(shape, x, wt, b)
        n, c, h, w = shape
        case(f"K8 {shape}", "rectify_head",
             lambda a=(x, wt, b): CH.rectify_head(*a),
             lambda a=(x, wt, b): CH.rectify_head_plain(*a), err,
             _nbytes(x, wt, b) + n * CH.CO * h * w * 4,
             2 * CH.KSIZE ** 2 * c * CH.CO * n * h * w,
             library=lambda a=(x, wt, b): cudnn_head_benchmarked(*a),
             library_name="cuDNN relu(conv2d), cudnn.benchmark on")

    # the video phase's frame, 1344x768 (1280x720 padded), under the paths'
    # move: K1 on the frames, K7 on the context, K2 depth-weighted, K3 and
    # K4; compared, not timed (the video phase times the video driver); own
    # draws, so the cases above keep their inputs
    gv, rngv = torch.Generator().manual_seed(7), np.random.RandomState(7)
    hv, wv = VIDEO_PADDED
    flow_v = _t(geo.smooth_flow(rngv, N, hv, wv, 0.5, (5.3, -3.1)), dev)
    filt_v = torch.randn(N, 16, hv, wv, generator=gv).to(dev)
    for c in (3, C_CTX):
        img = torch.rand(N, c, hv, wv, generator=gv).to(dev)
        _compare(f"{FI.forward_kernel(c)} C={c} at {tuple(img.shape)}",
                 FI.filter_interpolate(img, flow_v, filt_v),
                 FI.filter_interpolate_plain(img, flow_v, filt_v))
        del img
    acc_v, _, _ = _compare_scatter(
        "K2 depth-weighted, the video frame", flow_v,
        _t(geo.depth_weight(rngv, N, hv, wv), dev))
    _compare_k3(f"flow_project_finalize at {tuple(acc_v.shape)}",
                FP.finalize(acc_v), FP.finalize_plain(acc_v))
    shape_v = (1, 128, hv, wv)
    _compare_k4(shape_v, *(t.to(dev) for t in _trunk_inputs(gv, shape_v)))
    torch.cuda.synchronize()
    return cases


def _compare_scatter(name, flow, weight):
    """K2 against its plain version: the hit count equal bit for bit
    (unweighted: whole numbers, exact in any order), each channel within
    ATOL * max(1, |plain|) (the flow sums and a weight sum in the atomics'
    order).  Prints how many of the 8x32 tiles took the direct adds, and
    raises if the jump takes none.  Returns the sums, the max |kernel -
    plain| and that count."""
    got, direct = FP.scatter4_counted(flow, weight)
    want = FP.scatter4_plain(flow, weight)
    n, _, h, w = flow.shape
    if weight is None:
        if not torch.equal(got[:, 2], want[:, 2]):
            raise AssertionError(f"{name}: the hit count differs")
        print(f"[kernels] {name}: hit count equal bit for bit (total "
              f"{got[:, 2].sum().item():.0f}, max per cell "
              f"{got[:, 2].max().item():.0f})")
    err = max(_compare(f"flow_project_scatter {name} at {(n, h, w)}, channel "
                       f"{c}", got[:, c], want[:, c]) for c in range(3))
    tiles = n * math.ceil(h / 8) * math.ceil(w / 32)
    print(f"[kernels] {name}: {direct} of {tiles} 8x32 tiles took the direct "
          f"adds, the others summed in shared memory")
    if name.endswith("jump") and direct == 0:
        raise AssertionError(f"{name}: no tile took the direct adds")
    return got, err, direct


def index_add_call(flow, weight):
    """K2's yardstick: one ``index_add_`` of the 4 N H W targets' values
    into (3, N H W) sums, the targets and values built beforehand (the
    plain version's prep).  Timed only; the port never calls it."""
    idx, vals = FP.scatter4_targets(flow, weight)
    idx, vals = idx.reshape(-1), vals.repeat(1, 4)
    acc = torch.zeros(3, flow[:, 0].numel(), device=flow.device)
    return lambda: acc.index_add_(1, idx, vals)


def _scatter_bwd_case(case, label, flow, cot) -> None:
    """K6 at C = 2, ``flow_project_scatter_bwd``, against the autograd of the
    plain scatter under the (N,3,H,W) cotangent ``cot``, within ATOL x
    max(1, max |plain|); on the N = 6 draws of make_flow, launched twice and
    equal bit for bit (no atomics).  Registers the case "K6<label>", its
    yardstick one ``embedding_bag`` (held to the plain gradient too)."""
    key = "K6" + label
    f = flow.clone().requires_grad_()
    kernel = _grad_call(FP.scatter4, [f], cot)
    got = kernel()[0]
    want = torch.autograd.grad(FP.scatter4_plain(f), f, cot)[0]
    err = _compare_grad(f"flow_project_scatter_bwd{label} at "
                        f"{tuple(flow.shape)}", got, want)
    if "make_flow x3" in label:
        _check_repeat(key, got, kernel()[0])
    n, _, h, w = flow.shape
    table = cot[:, :2].permute(0, 2, 3, 1).reshape(-1, 2).contiguous()
    library = embedding_bag_call(flow, table, weighted=True)
    _compare_grad(f"{key}: its embedding_bag yardstick",
                  library().reshape(n, h, w, 2).permute(0, 3, 1, 2), want)
    # reads the flow and two cotangent channels, writes the flow gradient
    case(key, "flow_project_scatter_bwd", kernel,
         _grad_call(FP.scatter4_plain, [f], cot), err,
         _nbytes(flow, cot[:, :2], flow), _landings(flow, False) * 8,
         library=library, library_name="one embedding_bag")


def _depth_bwd_cases(case, label, flow, depth_inv, cot) -> None:
    """The depth projection's backward (K6's C = 3 use): the reference's,
    not autodiff, so held to its plain version (within ATOL x max(1, max
    |plain|)), on the weighted sums of
    ``flow``; with the depth gradient and without (gdepth NULL, ``out``
    unread: what the slow-motion train step runs), the latter only on the
    N = 6 and jump inputs; on the N = 6 draws of make_flow, launched twice
    and equal bit for bit.  Registers each as a ``case`` "K6 C=3
    (depth)<label>[ no depth grad]"; the N = 2 make_flow case without the
    depth gradient is its row of the kernels line, its yardstick one
    ``embedding_bag`` over the prebuilt field (the four-cell sum only)."""
    acc = FP.scatter4_plain(flow, depth_inv)
    args = (flow, depth_inv, cot, acc[:, 2].contiguous(),
            FP._count_average(acc))
    px = _landings(flow, False)
    n, _, h, w = flow.shape
    depth_cases = (True, False) if label in ("", " border") else (False,)
    for need_depth in depth_cases:
        tag = "" if need_depth else " no depth grad"
        key = f"K6 C=3 (depth){label}{tag}"
        got = FP.depth_flow_project_bwd(*args, need_depth=need_depth)
        want = FP.depth_flow_project_bwd_plain(*args, need_depth=need_depth)
        err = 0.0
        for name, a, b in zip(("flow", "depth"), got, want):
            if b is not None:
                err = max(err, _compare_grad(
                    f"depth_flow_project_bwd{label}{tag} at {(n, h, w)} "
                    f"grad->{name}", a, b))
        if "make_flow x3" in label:
            _check_repeat(key, got[0], FP.depth_flow_project_bwd(
                *args, need_depth=need_depth)[0])
        library = {}
        if key == ROW_CASE["depth_flow_project_bwd"]:
            a = args[2] / args[3].clamp(min=1e-30).unsqueeze(1)
            field = torch.cat([a, (a * args[4]).sum(1, keepdim=True)], 1)
            library = {"library": embedding_bag_call(
                flow, field.permute(0, 2, 3, 1).reshape(-1, 3).contiguous()),
                "library_name": "one embedding_bag, the four-cell sum only"}
        # reads flow, depth, g, cnt (and out); writes gflow (and gdepth)
        case(key, "depth_flow_project_bwd",
             lambda a=args, nd=need_depth: FP.depth_flow_project_bwd(
                 *a, need_depth=nd),
             lambda a=args, nd=need_depth:
             FP.depth_flow_project_bwd_plain(*a, need_depth=nd), err,
             _nbytes(*args[:4], flow, *((args[4], depth_inv) if need_depth
                                        else ())),
             px * (42 if need_depth else 22), **library)


def _check_repeat(key, first, second) -> None:
    if not torch.equal(first, second):
        raise AssertionError(f"{key}: two launches differ")
    print(f"[kernels] {key}: two launches equal bit for bit")


def embedding_bag_call(flow, table, weighted=False):
    """K6's yardstick: one ``F.embedding_bag`` (mode "sum") of the (N H W,
    C) channels-last ``table`` over each pixel's four cells, the (N H W, 4)
    cells of ``FP.scatter4_targets`` built beforehand; ``weighted``: with
    the per-sample weights -valid, which gives K6's C = 2 flow gradient
    under a cotangent whose first two channels are ``table``.  Timed only;
    the port never calls it."""
    idx, vals = FP.scatter4_targets(flow)
    idx = idx.t().contiguous()
    weights = (-vals[2]).unsqueeze(1).expand(-1, 4).contiguous() \
        if weighted else None
    return lambda: F.embedding_bag(idx, table, mode="sum",
                                   per_sample_weights=weights)


def _trunk_inputs(g: torch.Generator, shape):
    """A bf16 activation as the rectifier's block 1 leaves it (a ReLU of a
    unit normal) and six trunk conv weights at its init, normal(0,
    sqrt(2 / (9 * 128)))."""
    x = torch.relu(torch.randn(*shape, generator=g)).bfloat16()
    w6 = (torch.randn(RB.N_CONVS, RB.C, RB.C, 3, 3, generator=g)
          * (2.0 / (9 * RB.C)) ** 0.5).bfloat16()
    return x, w6


def cudnn_chain(x, w6):
    """K4's yardstick: the six convs as bf16 ``F.conv2d`` calls on cuDNN,
    the ReLU, residual add and cast in ATen (the residual added in bf16, the
    chained lane's rounding).  Timed only; the port never calls it."""
    h = x
    for k in range(RB.N_CONVS // 2):
        t = F.relu(F.conv2d(h, w6[2 * k], padding=1))
        h = F.relu(F.conv2d(t, w6[2 * k + 1], padding=1) + h)
    return h


def _head_inputs(g: torch.Generator, shape):
    """The rectifier head's input in [-1, 1), weights at its init (normal,
    std sqrt(2 / (49 C))) and a bias of +-0.01."""
    n, c, h, w = shape
    x = torch.rand(n, c, h, w, generator=g) * 2 - 1
    wt = torch.randn(CH.CO, c, 7, 7, generator=g) * (2.0 / (49 * c)) ** 0.5
    return x, wt, torch.randn(CH.CO, generator=g) * 0.01


def cudnn_head_benchmarked(x, wt, b):
    """K8's yardstick: cuDNN's float32 relu(conv2d) with cudnn.benchmark on
    (its choice among algorithms, made on the first call of a shape)."""
    torch.backends.cudnn.benchmark = True
    try:
        return F.relu(F.conv2d(x, wt, b, padding=CH.PAD))
    finally:
        torch.backends.cudnn.benchmark = False


def _compare_k8(shape, x, wt, b) -> float:
    """K8 against float64 and against its plain version on the card: each
    value's error over the float64 sum of |x||w| + |b| (what a float32 sum
    of its terms rounds within) at most K8_TOL against float64 (float32
    sums read 2.6-4.2e-7, TF32 products 1e-4 and more) and 2 K8_TOL
    against the plain version (cuDNN's float32 sum, in its own order); two
    launches bit for bit.  Returns max |kernel - plain|."""
    got, again = CH.rectify_head(x, wt, b), CH.rectify_head(x, wt, b)
    plain = CH.rectify_head_plain(x, wt, b)
    xd, wd, bd = x.double(), wt.double(), b.double()
    want = F.relu(F.conv2d(xd, wd, bd, padding=CH.PAD))
    scale = F.conv2d(xd.abs(), wd.abs(), bd.abs(), padding=CH.PAD)
    rel = ((got.double() - want).abs() / scale).max().item()
    rel_plain = ((plain.double() - want).abs() / scale).max().item()
    rel_apart = ((got.double() - plain.double()).abs() / scale).max().item()
    del xd, want, scale
    err = (got - plain).abs().max().item()
    same = torch.equal(got, again)
    print(f"[kernels] rectify_head K8 {shape}: error over sum |x||w| + |b| "
          f"{rel:.3e} against float64 (tolerance {K8_TOL:.0e}; the plain "
          f"version's {rel_plain:.3e}), {rel_apart:.3e} against the plain "
          f"version (tolerance {2 * K8_TOL:.0e}); max |kernel - plain| "
          f"{err:.3e}; two launches {'bit-equal' if same else 'DIFFER'}")
    if not (rel <= K8_TOL and rel_apart <= 2 * K8_TOL and same):
        raise AssertionError(f"rectify_head {shape}: failed its check")
    return err


def _compare_k4(shape, x, w6) -> float:
    """K4 against its plain version, per launch and per call.

    Per launch, each of the six convs from the same bf16 inputs as its
    plain conv, on channels-last tensors and the weights packed by the
    wrapper's own helper: |kernel - plain| <= K4_TOL * max(1, |plain|)
    elementwise (the sums run in another order, so a bf16 rounding flips by
    one ulp now and then).  Per call, through the wrapper from an NCHW
    input: the chain carries those flips on through the other convs, so an
    element's difference follows the activations' scale, not its own value:
    |kernel - plain| <= K4_TOL * max(1, max |plain|).  Returns the call's
    max |kernel - plain|."""
    n, _, h, w = shape
    taps = RB.pack_trunk_weights(w6)
    worst, h_in = 0.0, x.contiguous(memory_format=torch.channels_last)
    for k in range(RB.N_CONVS):
        res = None if k % 2 == 0 else block_in
        if k % 2 == 0:
            block_in = h_in
        out = torch.empty_like(h_in)
        kernels.launch("fused_resblocks", h_in, taps[k], res, out, n, h, w)
        pre = F.conv2d(h_in.float(), w6[k].float(), padding=1)
        want = F.relu(pre if res is None else pre + res.float()).bfloat16()
        worst = max(worst, ((out.float() - want.float()).abs()
                            / want.float().abs().clamp(min=1)).max().item())
        h_in = out
    got = RB.fused_resblocks(x, w6).float()
    want = RB.fused_resblocks_plain(x, w6).float()
    diff = (got - want).abs()
    err, scale = diff.max().item(), max(1.0, want.abs().max().item())
    print(f"[kernels] fused_resblocks at {shape}: per launch max |kernel - "
          f"plain| / max(1, |plain|) = {worst:.3e}; per call max |kernel - "
          f"plain| = {err:.3e} (max |plain| {scale:.3f}), scaled "
          f"{err / scale:.3e}, {(diff > 0).float().mean().item():.3%} of the "
          f"elements differ (tolerance {K4_TOL:.3e} for both)")
    if not (worst <= K4_TOL and err <= K4_TOL * scale):
        raise AssertionError(f"fused_resblocks at {shape}: {worst}, {err}")
    if not torch.equal(h_in.float(), got):
        raise AssertionError("fused_resblocks: the wrapper's call differs "
                             "from its six launches")
    return err


def _grads(fn, inputs, cot, which=None):
    """Gradients of ``fn`` under the cotangent ``cot`` w.r.t. the inputs
    numbered in ``which`` (default: every input)."""
    which = range(len(inputs)) if which is None else which
    ins = [t.detach().clone().requires_grad_(i in which)
           for i, t in enumerate(inputs)]
    return torch.autograd.grad(fn(*ins), [ins[i] for i in which], cot)


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


def _check_launches(path, launches, want_counts=None) -> None:
    """Each kernel of ``kernels.LAUNCHES`` launched exactly as often as
    ``PATHS[path]`` (or ``want_counts``) says."""
    for name in kernels.LAUNCHES:
        want = (want_counts or PATHS[path]).get(name, 0)
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


def make_slowmo_model(timestep: float = SLOWMO_T) -> torch.nn.Module:
    """DAINSlowMotion(timestep) at full width from seed 0, tamed as DAIN
    (the weights do not depend on the timestep)."""
    model = DAINSlowMotion(timestep,
                           generator=torch.Generator().manual_seed(0))
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


def make_frames(g: torch.Generator, h: int = H, w: int = W
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A smooth random scene and the same scene moved by (5, -3) px, both on
    the 8-bit grid, (1, 3, h, w)."""
    scene = F.interpolate(torch.rand(1, 3, h // 16 + 1, w // 16 + 1,
                                     generator=g),
                          size=(h + 10, w + 10), mode="bicubic",
                          align_corners=False).clamp(0, 1)
    i0 = scene[:, :, 5:5 + h, 5:5 + w]
    i2 = scene[:, :, 2:2 + h, 10:10 + w]
    q = lambda x: torch.round(x * 255) / 255
    return q(i0).contiguous(), q(i2).contiguous()


def _violations(got, want, rtol, atol):
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    return diff.max().item(), int(bad.sum().item())


def _hold_to_cpu(tag, checks) -> None:
    """Each (name, GPU tensor, CPU tensor, atol) within rtol 1e-3."""
    failed = []
    for name, got, want, atol in checks:
        worst, nbad = _violations(got.cpu(), want, 1e-3, atol)
        print(f"[{tag}] GPU vs CPU {name}: max |diff| {worst:.3e}, "
              f"{nbad} elements beyond rtol 1e-3 atol {atol:.0e}")
        if nbad:
            failed.append(name)
    if failed:
        raise AssertionError(f"GPU and CPU forwards disagree: {failed}")


def _check_finite(out) -> None:
    for key, pair in out.items():
        for t in pair:
            for x in (t if isinstance(t, list) else [t]):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"non-finite values in {key}")


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
    _check_launches("eval_forward", launches)
    _check_finite(out)
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
    _hold_to_cpu("slice", [
        ("offsets[0]", out["offsets"][0], ref["offsets"][0], 1e-4),
        ("offsets[1]", out["offsets"][1], ref["offsets"][1], 1e-4),
        ("cur_output", out["outputs"][0], ref["outputs"][0], 2e-4),
        ("rectified", out["outputs"][1], ref["outputs"][1], 2e-4)])

    with torch.inference_mode():
        t = cuda_times_ms(lambda: model(i0d, i2d))
    ms = statistics.median(t)
    print(f"[times] DAIN eval 448x256 B=1 float32 TF32 off: {ms:.3f} ms/frame, "
          f"{1000.0 / ms:.2f} frames/s (median of {len(t)} after 10 "
          f"warm-up; p80 {_p80(t):.3f} ms, min {t[0]:.3f}, max {t[-1]:.3f})")
    return launches


def _p80(t):
    """The highest percentile with ten samples beyond it, of 50."""
    return t[int(0.8 * len(t)) - 1]


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


def phase_slowmo(dev: torch.device):
    """DAINSlowMotion(0.25) at 448x256: launches, outputs against the CPU."""
    t0 = time.perf_counter()
    model = make_slowmo_model().to(dev)
    i0, i2 = make_frames(torch.Generator().manual_seed(1))
    i0d, i2d = i0.to(dev), i2.to(dev)
    with torch.inference_mode():
        kernels.reset_launches()
        out = model(i0d, i2d)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        depth_inv = depth_inv_from_log_depth(
            model.depthNet(torch.cat([i0d, i2d], 0)))
    print(f"[slowmo] launches in one DAINSlowMotion({SLOWMO_T}) forward: "
          f"{launches}")
    _check_launches("slowmo_forward", launches)
    _check_finite(out)
    frames, rects = out["outputs"]
    n_frames = round(1 / SLOWMO_T) - 1
    if len(frames) != n_frames or len(rects) != n_frames or any(
            tuple(x.shape) != (1, 3, H, W) for x in frames + rects):
        raise AssertionError("slow-motion outputs: wrong count or shape")
    print(f"[slowmo] {n_frames} frames, outputs finite; depth_inv in "
          f"[{depth_inv.min().item():.4f}, {depth_inv.max().item():.4f}]; "
          f"max |offset| {out['offsets'][0].abs().max().item():.3f} px; mean "
          f"rectified {[round(r.mean().item(), 4) for r in rects]}")

    cpu_model = copy.deepcopy(model).cpu()
    t1 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_model(i0, i2)
    print(f"[slowmo] the CPU forward took {time.perf_counter() - t1:.1f} s")
    if kernels.LAUNCHES != launches:
        raise AssertionError("the CPU forward launched a kernel")
    checks = [(f"offsets[{k}] (last step)", out["offsets"][k],
               ref["offsets"][k], 1e-4) for k in range(2)]
    for s in range(n_frames):
        checks.append((f"step {s} output", frames[s], ref["outputs"][0][s],
                       2e-4))
        checks.append((f"step {s} rectified", rects[s], ref["outputs"][1][s],
                       2e-4))
    _hold_to_cpu("slowmo", checks)
    print(f"[slowmo] phase check took {time.perf_counter() - t0:.1f} s")
    return model, i0d, i2d, launches


def phase_slowmo_times(model, i0, i2) -> float:
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t = cuda_times_ms(lambda: model(i0, i2))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(t)
    k = model.num_frames
    print(f"[times] DAINSlowMotion({SLOWMO_T}) 448x256 B=1 float32 TF32 off: "
          f"{ms:.3f} ms/forward, {ms / k:.3f} ms per synthesised frame "
          f"({k} a forward; median of {len(t)} after 10 warm-up; p80 "
          f"{_p80(t):.3f} ms, min {t[0]:.3f}, max {t[-1]:.3f} ms/forward); "
          f"peak memory {peak:.3f} GiB")
    return ms


def _busy(events):
    """(busy, span) in us: the union of the device intervals, and the
    window from the first start to the last end."""
    busy, run_s, run_e = 0.0, None, None
    for s0, e0, _ in events:
        if run_e is None or s0 > run_e:
            busy += 0.0 if run_e is None else run_e - run_s
            run_s, run_e = s0, e0
        else:
            run_e = max(run_e, e0)
    busy += run_e - run_s
    return busy, events[-1][1] - events[0][0]


def _device_events(prof):
    """(start, end, name) in us of every device kernel and copy, sorted; the
    user annotations that the profiler also puts on the device timeline
    (``Optimizer.step#Adamax.step``) are left out."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def _profile_whole(unit, fn, reps, kernel_names):
    """torch.profiler over ``reps`` calls of ``fn``: device events a call,
    the busy and idle share, each named kernel's device time, the largest
    device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a session may now and then record no device event: up to 3 sessions
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
    else:
        raise AssertionError("torch.profiler recorded no device events in "
                             "3 sessions")
    busy, span = _busy(events)
    print(f"[profile] {reps} {unit}s under torch.profiler: "
          f"{len(events) // reps} device events a {unit}, busy "
          f"{busy / 1000 / reps:.3f} ms of a {span / 1000 / reps:.3f} ms "
          f"window a {unit}: idle {1 - busy / span:.1%}")
    for name in kernel_names:
        ts = [e - s0 for s0, e, n in events if f"{name}_kernel" in n]
        med = f"{statistics.median(ts):.2f} us" if ts else "none recorded"
        print(f"[profile] {name} in the {unit}: {len(ts) / reps:g} launches "
              f"a {unit} recorded, median device time {med}")
    names = {n for _, _, n in events}
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.key in names),
                 key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        ms = e.self_device_time_total / 1000 / reps
        print(f"[profile] top device kernel: {ms:8.3f} ms a {unit}, "
              f"{e.count // reps:5d} launches a {unit}, {e.key[:90]}")


def phase_slowmo_profile(dev, forward_ms) -> None:
    """Where the slow-motion forward's time goes, on the model and frames
    of phase_slowmo made anew: each stage on its own inputs (CUDA events,
    median of 15 after 3 warm-up), then torch.profiler over whole
    forwards."""
    t0 = time.perf_counter()
    model = make_slowmo_model().to(dev)
    i0, i2 = (x.to(dev) for x in make_frames(torch.Generator().manual_seed(1)))
    b = i0.shape[0]
    with torch.inference_mode():
        frames = torch.cat([i0, i2], 0)
        log_depth = model.depthNet(frames)
        depth_inv = depth_inv_from_log_depth(log_depth)
        ctx = torch.cat([model.ctxNet(frames), log_depth], 1)
        trunk = model.initScaleNets_filter(torch.cat([i0, i2], 1))
        filt0 = model.initScaleNets_filter1(trunk)
        filt1 = model.initScaleNets_filter2(trunk)
        filt = torch.cat([filt0, filt1], 0)
        raw_fwd, raw_bwd = model.flownets.bidirectional(i0, i2)

        def heads():
            tr = model.initScaleNets_filter(torch.cat([i0, i2], 1))
            return (model.initScaleNets_filter1(tr),
                    model.initScaleNets_filter2(tr))

        def project(t, t_rev):
            flows = upsample_bilinear(torch.cat(
                [raw_fwd * (DIV_FLOW * t), raw_bwd * (DIV_FLOW * t_rev)], 0), 4)
            return FP.depth_flow_project(flows, depth_inv, hole_fill=True)

        def frame_warp(offs, t):
            refs = FI.filter_interpolate(frames, offs, filt)
            return refs, refs[:b] * (1.0 - t) + refs[b:] * t

        stages = [("MegaDepth", lambda: model.depthNet(frames)),
                  ("S2DF", lambda: model.ctxNet(frames)),
                  ("MonoNet5 + 2 heads", heads),
                  ("PWC-Net bidirectional",
                   lambda: model.flownets.bidirectional(i0, i2))]
        steps = [k * SLOWMO_T for k in range(1, 1 + model.num_frames)]
        for k, (t, t_rev) in enumerate(zip(steps, steps[::-1])):
            offs = project(t, t_rev)
            ctx_w = FI.filter_interpolate(ctx, offs, filt)
            refs, out = frame_warp(offs, t)
            rect_in = torch.cat([out, refs[:b], refs[b:], offs[:b], offs[b:],
                                 filt0, filt1, ctx_w[:b], ctx_w[b:]], 1)
            stages += [
                (f"step {k} (t={t}) upsample + depth projection (K2, K3)",
                 lambda t=t, t_rev=t_rev: project(t, t_rev)),
                (f"step {k} ctx warp (K7)",
                 lambda o=offs: FI.filter_interpolate(ctx, o, filt)),
                (f"step {k} frame warp (K1) + blend",
                 lambda o=offs, t=t: frame_warp(o, t)),
                (f"step {k} rectifier",
                 lambda x=rect_in, o=out: model.rectifyNet(x) + o)]
        total = 0.0
        for name, fn in stages:
            ms = statistics.median(cuda_times_ms(fn, 3, 15))
            total += ms
            print(f"[profile] slowmo stage {name}: {ms:.3f} ms")
        print(f"[profile] slowmo stage sum {total:.3f} ms; the whole forward "
              f"{forward_ms:.3f} ms")
        _profile_whole("slow-motion forward", lambda: model(i0, i2), 3,
                       ("filter_interpolate_fwd", "filter_interpolate_ctx",
                        "flow_project_scatter", "flow_project_finalize"))
    print(f"[profile] slowmo profile took {time.perf_counter() - t0:.1f} s")


def make_triplets(g: torch.Generator, b: int, h: int = H, w: int = W):
    """``b`` training triplets: a smooth random scene per sample, the
    middle frame its centre crop (the target), the first and last frames
    the crops moved by -(5, -3) and +(5, -3) px; all on the 8-bit grid."""
    scene = F.interpolate(torch.rand(b, 3, h // 16 + 1, w // 16 + 1,
                                     generator=g),
                          size=(h + 12, w + 12), mode="bicubic",
                          align_corners=False).clamp(0, 1)
    crop = lambda dx, dy: scene[:, :, 6 + dy:6 + dy + h, 6 + dx:6 + dx + w]
    q = lambda x: (torch.round(x * 255) / 255).contiguous()
    return {"x0": q(crop(-5, 3)), "x1": q(crop(5, -3)), "y": q(crop(0, 0))}


def _train_steps(tag, path, model, opt, batch) -> dict:
    """TRAIN_STEPS train steps, each checked: the launches of ``path``, a
    finite loss, every parameter of each Adamax group whose gradient is over
    1e-6 moved.  Returns the last step's launches."""
    config = TrainConfig()
    for step in range(TRAIN_STEPS):
        before = {name: [p.detach().clone() for p in grp["params"]]
                  for name, grp in zip(GROUPS, opt.param_groups)}
        kernels.reset_launches()
        m = train_step(model, opt, batch, config)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        _check_launches(path, launches)
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
        print(f"[{tag}] step {step}: loss {total:.6f}, psnr "
              f"{float(m['psnr']):.3f} dB, launches {launches}, parameters "
              f"moved per group {moved}")
    return launches


def _eval_step(tag, model, batch, want_counts) -> None:
    kernels.reset_launches()
    m = eval_step(model, batch, TrainConfig())
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _check_launches(tag, launches, want_counts)
    if not math.isfinite(float(m["total"])):
        raise AssertionError(f"eval step: loss {float(m['total'])}")
    print(f"[{tag}] eval step: loss {float(m['total']):.6f}, psnr "
          f"{float(m['psnr']):.3f} dB, launches {launches}")


def phase_train(dev: torch.device):
    model = make_model().to(dev)
    opt = make_optimizer(model, TrainConfig())
    batch = {k: v.to(dev) for k, v in
             make_triplets(torch.Generator().manual_seed(2), TRAIN_B).items()}
    launches = _train_steps("train", "train_step", model, opt, batch)
    _eval_step("train", model, batch, PATHS["eval_forward"])
    return model, opt, batch, launches


def _train_vs_cpu(tag, dev, cpu, batch) -> None:
    """One train step from the same weights and batch on both devices; the
    loss to rtol 1e-4, the gradients per grouped leaf within rtol 5e-3,
    atol 5e-3 x the leaf's largest magnitude
    (tests/test_full_graph_backward.py's tolerance)."""
    config = TrainConfig()
    gpu = copy.deepcopy(cpu).to(dev)
    got = train_step(gpu, make_optimizer(gpu, config),
                     {k: v.to(dev) for k, v in batch.items()}, config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = train_step(cpu, make_optimizer(cpu, config), batch, config)
    b, _, h, w = batch["x0"].shape
    print(f"[{tag}] GPU vs CPU at B={b} {h}x{w}: the CPU step took "
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
        print(f"[{tag}] GPU vs CPU grads, group {group}: {n} leaves, worst "
              f"max|diff| / max|grad| {worst[0]:.3e} ({worst[1]}; rtol "
              f"5e-3, atol 5e-3 x max|grad|)")
    if failed:
        raise AssertionError(f"GPU and CPU gradients disagree: {failed}")


def phase_train_vs_cpu(dev: torch.device) -> None:
    _train_vs_cpu("train", dev, make_model(),
                  make_triplets(torch.Generator().manual_seed(3), CPU_B))


def phase_slowmo_train(dev: torch.device):
    """DAINSlowMotion(0.5).train() at B=3: TRAIN_STEPS checked steps, the
    frozen nets unchanged, one eval step."""
    model = make_slowmo_model(TRAIN_T).to(dev)
    opt = make_optimizer(model, TrainConfig())
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith(FROZEN)}
    batch = {k: v.to(dev) for k, v in
             make_triplets(torch.Generator().manual_seed(2), TRAIN_B).items()}
    launches = _train_steps("slowmo_train", "slowmo_train_step", model, opt,
                            batch)
    changed = [k for k, v in model.state_dict().items()
               if k in frozen and not torch.equal(v, frozen[k])]
    n_bn = sum(k.endswith(("running_mean", "running_var")) for k in frozen)
    if changed or not n_bn:
        raise AssertionError(f"frozen tensors changed: {changed}")
    print(f"[slowmo_train] after {TRAIN_STEPS} steps the {len(frozen)} "
          f"tensors of {', '.join(FROZEN)} ({n_bn} of them MegaDepth's BN "
          f"statistics) are unchanged bit for bit; MegaDepth in eval mode: "
          f"{not model.depthNet.training}")
    if model.depthNet.training:
        raise AssertionError("MegaDepth left eval mode")
    _eval_step("slowmo_train", model, batch, SLOWMO_EVAL_STEP)
    return model, opt, batch, launches


def phase_slowmo_train_vs_cpu(dev: torch.device) -> None:
    _train_vs_cpu("slowmo_train", dev, make_slowmo_model(TRAIN_T),
                  make_triplets(torch.Generator().manual_seed(3), CPU_B,
                                CPU_HW, CPU_HW))


def phase_train_times(model, opt, batch, name="DAIN") -> float:
    config = TrainConfig()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t = cuda_times_ms(lambda: train_step(model, opt, batch, config),
                      warmup=5, iters=20)
    ms = statistics.median(t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[times] {name} train step B={TRAIN_B} {H}x{W} float32 TF32 off: "
          f"{ms:.3f} ms/step (median of {len(t)} after 5 warm-up; p80 "
          f"{t[int(0.8 * len(t)) - 1]:.3f} ms, min {t[0]:.3f}, max "
          f"{t[-1]:.3f}); peak memory {peak:.3f} GiB, of which {held:.3f} "
          f"GiB held before the steps (the models and optimizers so far)")
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


def phase_train_profile(model, opt, batch, step_ms) -> None:
    """Where the train step's time goes: each stage's forward and backward
    on its own inputs, the Adamax step, and whole steps under
    torch.profiler."""
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
    _profile_whole("train step",
                   lambda: train_step(model, opt, batch, config), 3,
                   tuple(PATHS["train_step"]))


def phase_slowmo_train_profile(model, opt, batch, step_ms) -> None:
    """Where the slow-motion train step's time goes: the frozen nets'
    forwards (they record no graph), each trained stage's forward and
    backward on its own inputs, the Adamax step, and whole steps under
    torch.profiler."""
    x0, x1 = batch["x0"], batch["x1"]
    b = x0.shape[0]
    frames = torch.cat([x0, x1], 0)
    model.train()

    def heads(pair):
        trunk = model.initScaleNets_filter(pair)
        return torch.cat([model.initScaleNets_filter1(trunk),
                          model.initScaleNets_filter2(trunk)], 1)

    def pwc(a, c):
        return torch.cat(model.flownets.bidirectional(a, c), 0)

    def project(raw):
        flows = upsample_bilinear(raw * (DIV_FLOW * TRAIN_T), 4)
        return FP.depth_flow_project(flows, depth_inv, hole_fill=False)

    def warps(offs, filt):
        ctx_w = FI.filter_interpolate(ctx, offs.detach(), filt.detach())
        refs = FI.filter_interpolate(frames, offs, filt)
        out = refs[:b] * (1.0 - TRAIN_T) + refs[b:] * TRAIN_T
        return torch.cat([out, refs[:b], refs[b:], ctx_w[:b], ctx_w[b:]], 1)

    with torch.no_grad():      # each stage's inputs, from one forward
        log_depth = model.depthNet(frames)
        depth_inv = depth_inv_from_log_depth(log_depth)
        ctx = torch.cat([model.ctxNet(frames), log_depth], 1)
        f01 = heads(torch.cat([x0, x1], 1))
        filt = torch.cat([f01[:, :16], f01[:, 16:]], 0)
        raw = pwc(x0, x1)
        offs = project(raw)
        w = warps(offs, filt)
        rect_in = torch.cat([w[:, :9], offs[:b], offs[b:], f01,
                             w[:, 9:]], 1)
    frozen = [("MegaDepth (frozen)", lambda: model.depthNet(frames)),
              ("S2DF (frozen)", lambda: model.ctxNet(frames))]
    stages = [
        ("MonoNet5 + 2 heads", heads, [torch.cat([x0, x1], 1)], False),
        ("PWC-Net bidirectional", pwc, [x0, x1], False),
        ("upsample x4 + depth projection (K2, depth backward)", project,
         [raw], True),
        ("ctx warp (K7) + frame warp (K1, K5) + blend", warps, [offs, filt],
         True),
        ("rectifier 437 -> 3", model.rectifyNet, [rect_in], True),
    ]
    sum_f = sum_b = 0.0
    for name, fwd in frozen:
        with torch.no_grad():
            t_f = statistics.median(cuda_times_ms(fwd, 3, 15))
        sum_f += t_f
        print(f"[profile] slowmo train stage {name}: forward {t_f:.3f} ms")
    for name, fwd, ins, need_grad in stages:
        t_f, t_b = _stage_ms(model, fwd, ins, need_grad)
        sum_f, sum_b = sum_f + t_f, sum_b + t_b
        print(f"[profile] slowmo train stage {name}: forward {t_f:.3f} ms, "
              f"backward {t_b:.3f} ms")
    config = TrainConfig()
    train_step(model, opt, batch, config)
    t_opt = statistics.median(cuda_times_ms(opt.step, 3, 15))
    n_tensors = sum(len(g["params"]) for g in opt.param_groups)
    print(f"[profile] slowmo train stage Adamax step ({n_tensors} tensors): "
          f"{t_opt:.3f} ms")
    print(f"[profile] slowmo train stage sums: forward {sum_f:.3f} ms, "
          f"backward {sum_b:.3f} ms, with Adamax {sum_f + sum_b + t_opt:.3f} "
          f"ms; the whole step {step_ms:.3f} ms")
    _profile_whole("slow-motion train step",
                   lambda: train_step(model, opt, batch, config), 3,
                   tuple(PATHS["slowmo_train_step"]))


def phase_call_times(cases) -> dict:
    """Per case: the time per call with the wrapper and the plain
    version's (CUDA events), and the bound."""
    times = {}
    for key, c in cases.items():
        # ten calls a sample where one is short (small tensors, few FLOPs)
        inner = 10 if c["bytes"] < 1e8 and c["ops"] < 1e10 else 1
        call = statistics.median(cuda_times_ms(c["fn"], inner=inner))
        plain = statistics.median(cuda_times_ms(c["plain"], inner=inner))
        library = (statistics.median(cuda_times_ms(c["library"], inner=inner))
                   if c["library"] else None)
        t_bytes = c["bytes"] / HBM_BYTES_S * 1e3
        t_ops = c["ops"] / c["peak"] * 1e3
        times[key] = {"call_ms": call, "plain_ms": plain,
                      "library_ms": library,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        lib = ("" if library is None else
               f", {c['library_name']} {library * 1000:.1f} us")
        print(f"[times] {key} ({c['kernel']}): per call {call * 1000:.1f} us "
              f"with the wrapper, plain {plain * 1000:.1f} us{lib} (CUDA "
              f"events, median of 50 x {inner}); bound "
              f"{times[key]['bound_ms'] * 1000:.2f} us by "
              f"{times[key]['bound_by']} ({c['bytes'] / 1e6:.2f} MB, "
              f"{c['ops'] / 1e9:.3f} GFLOP at {c['peak'] / 1e12:.0f} "
              f"TFLOP/s)")
    return times


def phase_device_times(cases, times) -> None:
    """Per case: the device time per launch (torch.profiler), beside the
    bound; into ``times[case]["ms"]``."""
    from torch.profiler import ProfilerActivity, profile

    for key, c in cases.items():
        # the profiler may drop a session's first events, now and then all
        # of them (two sessions in a row recorded no launch of K2 at
        # 2x37x76): sessions of 20 calls until one records at least 10
        # launches, at most 5, and the median of what that one records
        per_call = c["per_call"]
        for session in range(1, 6):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    c["fn"]()
                torch.cuda.synchronize()
            dev_us = [e - s0 for s0, e, n in _device_events(prof)
                      if f"{c['kernel']}_kernel" in n]
            if len(dev_us) >= 10:
                break
        if not 10 <= len(dev_us) <= 20 * per_call:
            raise AssertionError(f"{key}: {len(dev_us)} launches of "
                                 f"{c['kernel']} recorded in 20 calls, in "
                                 f"each of {session} sessions")
        launch_ms = statistics.median(dev_us) / 1000
        ms = times[key]["ms"] = launch_ms * per_call
        bound = times[key]["bound_ms"]
        each = ("" if per_call == 1 else
                f" ({per_call} launches of {launch_ms * 1000:.2f} us)")
        if per_call > 1:
            times[key]["ms_per_launch"] = launch_ms
        which = "" if session == 1 else f" in session {session}"
        print(f"[times] {key} ({c['kernel']}): device {ms * 1000:.2f} us a "
              f"call{each} (median of {len(dev_us)} launches{which}), bound "
              f"{bound * 1000:.2f} us: {bound / ms:.1%} of it")
        if c["library"] is not None:
            lib_ms, events = _device_ms_a_call(c["library"])
            times[key]["library_device_ms"] = lib_ms
            print(f"[times] {key}: {c['library_name']} device {lib_ms * 1000:.2f}"
                  f" us a call ({events} device events a call), "
                  f"{times[key]['library_ms'] * 1000:.2f} us a call with its "
                  f"host (CUDA events)")


def _device_ms_a_call(fn, calls=20) -> tuple[float, int]:
    """The device time of one call of ``fn``, all its kernels and copies,
    under torch.profiler: three sessions of ``calls`` calls; the events of a
    call from the fullest session, rounded up (the profiler may drop a
    session's first events, now and then all of them), times the largest
    mean event of the sessions that kept at least half as many.  Also the
    events a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sessions = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        sessions.append([e - s0 for s0, e, _ in _device_events(prof)])
    most = max(len(d) for d in sessions)
    if 2 * most < calls:
        raise AssertionError(f"torch.profiler recorded {most} device events "
                             f"in {calls} calls")
    per_call = math.ceil(most / calls)
    mean = max(sum(d) / len(d) for d in sessions if 2 * len(d) >= most)
    return mean * per_call / 1000, per_call


def _bf16_twin(model: torch.nn.Module) -> torch.nn.Module:
    """The bf16 lane of ``model`` (DAIN or DAINSlowMotion) on its weights."""
    if isinstance(model, DAINSlowMotion):
        twin = DAINSlowMotion(model.timestep, compute_dtype="bfloat16")
    else:
        twin = DAIN(compute_dtype="bfloat16")
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device)


def _hold_to_f32_lane(tag, frames, others) -> None:
    """The bf16 lane's frames against the float32 lane's: mean and max
    |diff| and the PSNR (peak 1) within LANE_*; ``others`` (name, bf16,
    f32, bound) each by max |diff|."""
    failed = []
    for name, got, want in frames:
        d = (got - want).abs()
        mean, worst = d.mean().item(), d.max().item()
        psnr = 10 * math.log10(1.0 / (d * d).mean().item())
        print(f"[{tag}] bf16 vs float32 lane, {name}: max |diff| "
              f"{worst:.4e}, mean {mean:.4e}, PSNR {psnr:.2f} dB (bounds "
              f"{LANE_MAX}, {LANE_MEAN}, {LANE_PSNR} dB)")
        if not (worst <= LANE_MAX and mean <= LANE_MEAN and psnr >= LANE_PSNR):
            failed.append(name)
    for name, got, want, bound in others:
        worst = (got - want).abs().max().item()
        print(f"[{tag}] bf16 vs float32 lane, {name}: max |diff| "
              f"{worst:.4e} (bound {bound:.0e})")
        if not worst <= bound:
            failed.append(name)
    if failed:
        raise AssertionError(f"the bf16 lane is off the float32 lane: "
                             f"{failed}")


def phase_eval_bf16(dev: torch.device):
    """DAIN's bf16 lane at 448x256 on phase_slice's weights and frames:
    launches, the frames against the float32 lane, ms/frame."""
    f32 = make_model().eval().to(dev)
    model = _bf16_twin(f32)
    i0, i2 = (x.to(dev) for x in make_frames(torch.Generator().manual_seed(1)))
    with torch.inference_mode():
        want = f32(i0, i2)
        kernels.reset_launches()
        out = model(i0, i2)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    print(f"[eval_bf16] launches in one bf16 DAIN eval forward: {launches}")
    _check_launches("eval_forward_bf16", launches)
    _check_finite(out)
    # the offsets are float32 computations in both lanes (the projection's
    # atomics sum in any order); the filters come out of bf16 convs
    _hold_to_f32_lane("eval_bf16", [
        ("rectified", out["outputs"][1], want["outputs"][1]),
        ("cur_output", out["outputs"][0], want["outputs"][0])], [
        ("offsets", torch.cat(out["offsets"]), torch.cat(want["offsets"]),
         1e-4),
        ("filters", torch.cat(out["filters"]), torch.cat(want["filters"]),
         LANE_MAX)])
    with torch.inference_mode():
        t = cuda_times_ms(lambda: model(i0, i2))
    ms = statistics.median(t)
    print(f"[times] DAIN eval 448x256 B=1 bf16 lane: {ms:.3f} ms/frame, "
          f"{1000.0 / ms:.2f} frames/s (median of {len(t)} after 10 warm-up; "
          f"p80 {_p80(t):.3f} ms, min {t[0]:.3f}, max {t[-1]:.3f})")
    return model, i0, i2, launches


def phase_slowmo_bf16(dev: torch.device):
    """DAINSlowMotion(0.25)'s bf16 lane at 448x256: launches, each step's
    frames against the float32 lane, ms a forward and a frame, peak
    memory."""
    f32 = make_slowmo_model().to(dev)
    model = _bf16_twin(f32)
    i0, i2 = (x.to(dev) for x in make_frames(torch.Generator().manual_seed(1)))
    with torch.inference_mode():
        want = f32(i0, i2)
        kernels.reset_launches()
        out = model(i0, i2)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    del f32
    print(f"[slowmo_bf16] launches in one bf16 DAINSlowMotion({SLOWMO_T}) "
          f"forward: {launches}")
    _check_launches("slowmo_forward_bf16", launches)
    _check_finite(out)
    frames = []
    for s in range(model.num_frames):
        frames.append((f"step {s} rectified", out["outputs"][1][s],
                       want["outputs"][1][s]))
        frames.append((f"step {s} output", out["outputs"][0][s],
                       want["outputs"][0][s]))
    _hold_to_f32_lane("slowmo_bf16", frames, [
        ("last step's offsets", torch.cat(out["offsets"]),
         torch.cat(want["offsets"]), 1e-4)])
    del want, out
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    with torch.inference_mode():
        t = cuda_times_ms(lambda: model(i0, i2))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(t)
    k = model.num_frames
    print(f"[times] DAINSlowMotion({SLOWMO_T}) 448x256 B=1 bf16 lane: "
          f"{ms:.3f} ms/forward, {ms / k:.3f} ms per synthesised frame ({k} a "
          f"forward; median of {len(t)} after 10 warm-up; p80 {_p80(t):.3f} "
          f"ms, min {t[0]:.3f}, max {t[-1]:.3f} ms/forward); peak memory "
          f"{peak:.3f} GiB, of which {held:.3f} GiB held before the forwards "
          f"(the paths' models and the train step's state)")
    return model, i0, i2, launches


def make_pairs(g: torch.Generator, n: int, h: int, w: int):
    """``n`` synthetic Middlebury triplets, (H,W,3) float32 on the 8-bit
    grid: a smooth random scene, the frames its crops moved by -(4, 2) and
    +(4, 2) px, the ground truth the centre crop."""
    pairs = []
    for i in range(n):
        scene = F.interpolate(torch.rand(1, 3, h // 16 + 1, w // 16 + 1,
                                         generator=g),
                              size=(h + 8, w + 8), mode="bicubic",
                              align_corners=False).clamp(0, 1)[0]
        crop = lambda dx, dy: torch.round(
            scene[:, 4 + dy:4 + dy + h, 4 + dx:4 + dx + w] * 255) / 255
        pairs.append((f"pair{i}", *(crop(dx, dy).permute(1, 2, 0).numpy()
                                    for dx, dy in ((-4, -2), (4, 2), (0, 0)))))
    return pairs


def make_middlebury_model() -> torch.nn.Module:
    """DAIN for the Middlebury phase: make_model's weights, but with kernels
    that blur the 4x4 window to a unit sum (the heads' last conv zero, its
    bias 1/4: the bilinear quadrant weights sum to 4 over the window) and a
    rectifier that adds a small correction (its last conv x0.01), so
    the synthesised frames, and the metrics on them, are frames."""
    model = make_model()
    with torch.no_grad():
        for head in (model.initScaleNets_filter1, model.initScaleNets_filter2):
            head[2].weight.zero_()
            head[2].bias.fill_(0.25)
        for p in model.rectifyNet.block5.parameters():
            p.mul_(0.01)
    return model


def phase_middlebury(dev: torch.device):
    """The Middlebury app's core in the bf16 lane at 640x480 (padded to
    704x512), on make_middlebury_model's weights: launches, frames, metrics,
    and its device time a pair; the float32 lane's metrics beside it."""
    f32 = make_middlebury_model().eval().to(dev)
    model = _bf16_twin(f32)
    pairs = make_pairs(torch.Generator().manual_seed(4), MB_PAIRS, MB_H, MB_W)
    kernels.reset_launches()
    results, summary = demo_middlebury.evaluate(model, pairs, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"[middlebury] launches over {MB_PAIRS} pairs at {MB_W}x{MB_H}: "
          f"{launches}")
    _check_launches("middlebury_bf16", launches)
    for r in results:
        if r["frame"].shape != (MB_H, MB_W, 3) or not all(
                math.isfinite(r[k]) for k in ("ie", "psnr", "ssim")) \
                or not -1.0 <= r["ssim"] <= 1.0:
            raise AssertionError(f"middlebury: bad result for {r['name']}")
    _, f32_summary = demo_middlebury.evaluate(f32, pairs, dev)
    _, timed = demo_middlebury.evaluate(model, pairs[:1], dev,
                                        measure_time=True)
    print(f"[middlebury] bf16 lane: IE {summary['avg_ie']:.4f}, PSNR "
          f"{summary['avg_psnr']:.4f}, SSIM {summary['avg_ssim']:.5f}; "
          f"float32 lane: IE {f32_summary['avg_ie']:.4f}, PSNR "
          f"{f32_summary['avg_psnr']:.4f}, SSIM "
          f"{f32_summary['avg_ssim']:.5f} ({summary['sequences']} pairs)")
    print(f"[times] Middlebury core 640x480 (padded 704x512) B=1 bf16 lane: "
          f"{timed['device_time_per_pair_s'] * 1000:.3f} ms a pair (CUDA "
          f"events, median of 5 forwards after 1)")
    return launches


def make_clip(g: torch.Generator, n: int, h: int, w: int) -> list:
    """``n`` frames of a smooth random scene as make_frames makes it, each
    moved (5, -3) px from the last, (h, w, 3) uint8."""
    scene = F.interpolate(torch.rand(1, 3, h // 16 + 1, w // 16 + 1,
                                     generator=g),
                          size=(h + 3 * n, w + 5 * n), mode="bicubic",
                          align_corners=False).clamp(0, 1)[0]
    return [torch.round(scene[:, 3 * (n - 1 - k):3 * (n - 1 - k) + h,
                              5 * k:5 * k + w] * 255).to(torch.uint8)
            .permute(1, 2, 0).contiguous().numpy() for k in range(n)]


def _median_s(fn, reps=3) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def phase_png_times(frames, tmp: Path) -> None:
    """The host's PNG times on the clip's frames: write_png, read_png of
    its files (Up rows), and read_png of the frame filtered as PIL's
    encoder filters it (torch_png.pil_kinds: mostly Paeth on these frames,
    decoded diagonal by diagonal) at 1280x720 and at Vimeo-90K's 256x448."""
    frame = frames[0]
    path = tmp / "write.png"
    t_write = _median_s(lambda: write_png(path, frame), 5)
    t_read = _median_s(lambda: read_png(path), 5)
    if not np.array_equal(read_png(path), frame):
        raise AssertionError("write_png / read_png do not round-trip")
    print(f"[video] write_png {VIDEO_W}x{VIDEO_H} RGB (Up rows, zlib level "
          f"{ZLIB_LEVEL}): "
          f"{t_write * 1000:.3f} ms, {path.stat().st_size} bytes; read_png "
          f"of it {t_read * 1000:.3f} ms (medians of 5, host clock)")
    for label, img in ((f"{VIDEO_W}x{VIDEO_H}", frame),
                       ("448x256", frame[:256, :448])):
        kinds = torch_png.pil_kinds(img)
        pil = tmp / "pil.png"
        pil.write_bytes(torch_png.png_bytes(img, kinds))
        if not np.array_equal(read_png(pil), img):
            raise AssertionError("the PIL-filtered frame decodes wrong")
        t_pil = _median_s(lambda: read_png(pil))
        print(f"[video] read_png of a {label} frame filtered as PIL filters "
              f"it (rows per filter None/Sub/Up/Avg/Paeth "
              f"{np.bincount(kinds, minlength=5).tolist()}): "
              f"{t_pil * 1000:.3f} ms (median of 3, host clock)")


def _run_captured(tag, fn, argv):
    """``fn(argv)`` with its standard output and error captured and echoed
    under ``[tag]``; returns (result, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn(argv)
    for line in (out.getvalue() + err.getvalue()).splitlines():
        print(f"[{tag}] | {line}")
    return result, out.getvalue(), err.getvalue()


def _video_reference(model, frames, dev) -> list:
    """Each pair's synthesised frames from ``model`` run in memory on the
    same padded frames: round(clip(unpad(forward))), (H, W, 3) uint8."""
    want = []
    to = lambda f: torch.from_numpy(f).to(dev).permute(2, 0, 1)[None] \
        .contiguous().float() / 255.0
    with torch.inference_mode():
        for a, b in zip(frames[:-1], frames[1:]):
            ap_, pads = pad_to_multiple(to(a))
            bp_, _ = pad_to_multiple(to(b))
            if tuple(ap_.shape[2:]) != VIDEO_PADDED:
                raise AssertionError(f"padded to {tuple(ap_.shape[2:])}")
            for o in model(ap_, bp_)["outputs"][1]:
                want.append((torch.round(unpad(o, pads).clamp(0, 1) * 255)
                             [0].permute(1, 2, 0).to(torch.uint8).cpu()
                             .numpy()))
    return want


def _level_diff(got, want) -> np.ndarray:
    """|got - want| in 8-bit levels over lists of uint8 frames."""
    return np.stack([np.abs(a.astype(np.int16) - b.astype(np.int16))
                     for a, b in zip(got, want)])


def write_pil_filtered(path, frame) -> None:
    """``frame`` as a PNG whose rows are filtered as PIL's encoder filters
    them (torch_png.pil_kinds: mostly Paeth), as users' frames come."""
    Path(path).write_bytes(torch_png.png_bytes(frame, "pil"))


@contextlib.contextmanager
def run_to_run_stable():
    """The slow-motion forward with its two sums in any order made
    deterministic: K2 summed on the host, and cuDNN held to deterministic
    algorithms (its default for a transposed convolution sums in any
    order)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with k2_summed_on_the_host():
            yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def k2_summed_on_the_host():
    """K2 replaced by its plain version run on the CPU, which sums each
    cell's adds in index order: the same sums on every run."""
    launch = FP._launch_scatter4

    def plain(flow, weight, direct_tiles=None):
        return FP.scatter4_plain(
            flow.cpu(), None if weight is None else weight.cpu()).to(
            flow.device)

    FP._launch_scatter4 = plain
    try:
        yield
    finally:
        FP._launch_scatter4 = launch


def _run_video_driver(in_dir, out_dir, pth, lane, dev, path) -> tuple:
    """interpolate_video.main on ``in_dir`` in ``lane``, its launches held
    to PATHS[path]: (summary, its decode / forward / encode seconds, the
    peak and the held memory in GiB)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    summary, _, err = _run_captured("video", interpolate_video.main, [
        "--frames-dir", str(in_dir), "--out-dir", str(out_dir),
        "--model", "DAIN_slowmotion", "--time-step", str(SLOWMO_T),
        "--torch-checkpoint", str(pth), "--compute-dtype", lane,
        "--device", str(dev)])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[video] {lane} lane launches: {launches}")
    _check_launches(path, launches)
    return summary, json.loads(err.strip().splitlines()[-1]), peak, held


def _print_video_times(label, lane, summary, stages, peak, held) -> None:
    wall = summary["wall_s"]
    split = ", ".join(f"{k[:-2]} {v:.3f} s ({v / wall:.1%})"
                      for k, v in stages.items())
    print(f"[times] video driver {VIDEO_W}x{VIDEO_H} (run at "
          f"{VIDEO_PADDED[1]}x{VIDEO_PADDED[0]}), DAINSlowMotion("
          f"{SLOWMO_T}) {lane}, {VIDEO_FRAMES} PNG frames in ({label}), "
          f"{summary['interpolated_frames']} synthesised: "
          f"interp_frames_per_sec {summary['interp_frames_per_sec']:.4f}"
          f" (wall {wall:.3f} s, the first pair's set-up included); "
          f"driver's timers: {split}; peak memory {peak:.3f} GiB, "
          f"of which {held:.3f} GiB held before the run")


def phase_video(dev: torch.device) -> dict:
    """The video driver (vfidkr_torch.apps.interpolate_video.main) on a
    4-frame 1280x720 PNG clip filtered as PIL filters it, DAINSlowMotion(0.25)
    from a reference-layout .pth of make_slowmo_model's weights, in the
    float32 lane and in the bf16 lane: the files, the pass-through frames,
    each synthesised frame against the same model run in memory, the
    launches, frames/s and the driver's decode / forward / encode split,
    peak memory.  In the bf16 lane also: the in-memory forward's own
    run-to-run spread, and two runs with K2 summed on the host and cuDNN
    deterministic, which must agree bit for bit; and, as a second reading,
    the driver on the clip written by the port's own writer (Up rows).
    Returns each lane's launches."""
    frames = make_clip(torch.Generator().manual_seed(1), VIDEO_FRAMES,
                       VIDEO_H, VIDEO_W)
    f32 = make_slowmo_model()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="vfidkr_video_") as tmp:
        tmp = Path(tmp)
        (tmp / "in").mkdir()
        (tmp / "in_up").mkdir()
        for k, frame in enumerate(frames, start=1):
            write_pil_filtered(tmp / "in" / f"{k:05d}.png", frame)
            write_png(tmp / "in_up" / f"{k:05d}.png", frame)
        phase_png_times(frames, tmp)
        pth = tmp / "slowmo.pth"
        torch.save(reference_state_dict(f32), pth)
        f32 = f32.to(dev)
        names = sorted([f"{i:05d}000.png" for i in range(1, VIDEO_FRAMES + 1)]
                       + [f"{i:05d}{j:03d}.png" for i in range(1, VIDEO_FRAMES)
                          for j in range(1, round(1 / SLOWMO_T))])
        for lane, path in (("float32", "video_slowmo"),
                           ("bfloat16", "video_slowmo_bf16")):
            out_dir = tmp / lane
            summary, stages, peak, held = _run_video_driver(
                tmp / "in", out_dir, pth, lane, dev, path)
            launches[path] = dict(kernels.LAUNCHES)
            if sorted(os.listdir(out_dir)) != names:
                raise AssertionError(f"video {lane}: files "
                                     f"{sorted(os.listdir(out_dir))}")
            for i, frame in enumerate(frames, start=1):
                if not np.array_equal(read_png(out_dir / f"{i:05d}000.png"),
                                      frame):
                    raise AssertionError(f"video {lane}: pass-through frame "
                                         f"{i} differs from the input")
            model = f32 if lane == "float32" else _bf16_twin(f32)
            want = _video_reference(model, frames, dev)
            got = [read_png(out_dir / n) for n in names
                   if not n.endswith("000.png")]
            diff = _level_diff(got, want)
            levels, share = VIDEO_LEVELS[lane], float((diff > 0).mean())
            print(f"[video] {lane} lane: {len(names)} files; pass-through "
                  f"frames equal to the input; the {len(got)} synthesised "
                  f"frames against the same model in memory: max |diff| "
                  f"{int(diff.max())} levels, {int((diff > 0).sum())} of "
                  f"{diff.size} values differ ({share:.4%}; bound: "
                  f"{levels} levels, {VIDEO_SHARE:.1%})")
            if diff.max() > levels or share > VIDEO_SHARE:
                raise AssertionError(f"video {lane}: a frame is "
                                     f"{int(diff.max())} levels off, "
                                     f"{share:.4%} of the values differ")
            if lane == "bfloat16":
                own = _level_diff(_video_reference(model, frames, dev), want)
                with run_to_run_stable():
                    once = _video_reference(model, frames, dev)
                    again = _level_diff(_video_reference(model, frames, dev),
                                        once)
                print(f"[video] bf16 lane in memory against itself: max "
                      f"{int(own.max())} levels, {int((own > 0).sum())} "
                      f"values differ; with K2 summed on the host and cuDNN "
                      f"deterministic, run twice: max {int(again.max())} "
                      f"levels, {int((again > 0).sum())} values differ")
                if again.any():
                    raise AssertionError("the bf16 lane changes from run to "
                                         "run with its sums made "
                                         "deterministic")
            _print_video_times("filtered as PIL filters them", lane,
                               summary, stages, peak, held)
            del model
        summary, stages, peak, held = _run_video_driver(
            tmp / "in_up", tmp / "bf16_up", pth, "bfloat16", dev,
            "video_slowmo_bf16")
        if sorted(os.listdir(tmp / "bf16_up")) != names:
            raise AssertionError("video bf16 (Up rows): files differ")
        _print_video_times("the port's own writer: Up rows", "bfloat16",
                           summary, stages, peak, held)
    return launches


def _epoch_ms_per_step(stdout: str, steps: int) -> dict:
    return {int(e): float(t) * 1000 / steps for e, t in re.findall(
        r"epoch (\d+) took ([0-9.]+)s", stdout)}


def _train_argv(data, save, dev) -> list:
    return ["--dataset-path", str(data), "--save-path", str(save),
            "--batch-size", str(TRAIN_B), "--steps-per-epoch",
            str(DISK_STEPS), "--val-batches", "1", "--patience",
            str(DISK_PATIENCE), "--factor", str(DISK_FACTOR), "--device",
            str(dev)]


def _print_disk_times(label, out, step_ms, card,
                      steps=DISK_READ_STEPS) -> None:
    per = _epoch_ms_per_step(out, steps)
    print(f"[times] {card}: DAIN train step from disk, B={TRAIN_B} "
          f"{DISK_HW[0]}x{DISK_HW[1]} float32, PNGs {label} "
          f"(epoch time / {steps} steps, host clock): "
          + ", ".join(f"epoch {e} {ms:.3f} ms/step" for e, ms in per.items())
          + f"; in memory {step_ms:.3f} ms/step (the train phase's median)")


def _draws(triplets, rng) -> list:
    """The records of a training batch, drawn in the reference's order."""
    return [vimeo90k.draw_augment(t[0].shape[:2], True, rng)
            for t in triplets]


def _plain_batch(triplets, records) -> dict:
    """A batch by the Python path, as the loader made it before the C++
    augment: apply_augment a sample, np.stack, the NHWC -> NCHW copy."""
    x0, x1, y = (np.stack(s) for s in zip(*(
        vimeo90k.apply_augment(t, r) for t, r in zip(triplets, records))))
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in (("x0", x0), ("x1", x1), ("y", y))}


def _native_batch(triplets, records) -> dict:
    """The same batch through the C++ augment: one call."""
    return native.augment_triplets(triplets, records, vimeo90k.CROP_HW)


def _same_batch(got, want, what) -> None:
    for k in ("x0", "x1", "y"):
        if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
            raise AssertionError(f"native augment differs from the Python "
                                 f"path: {what}, {k}")


def phase_native_augment(card: str) -> None:
    """The trainer's C++ host augment (vfidkr_torch.data.native): its build
    with g++, then its batches held bit for bit to the Python path at B=3
    and B=12 through Vimeo90KDataset (the 18 synthetic 256x448 triplets, and
    288x512 ones whose random crops have non-zero offsets), with the swap
    and each flip forced on, and both paths' host ms a batch."""
    t = time.perf_counter()
    lib = native.build()
    native.load_library()
    print(f"[native_augment] built {lib.name} with g++ in "
          f"{time.perf_counter() - t:.2f} s; {native.thread_count()} OpenMP "
          f"threads a call (OMP_NUM_THREADS="
          f"{os.environ.get('OMP_NUM_THREADS')}); OpenMP runtimes mapped: "
          f"{native.openmp_runtimes()}")
    with tempfile.TemporaryDirectory(prefix="vfidkr_aug_") as tmp:
        trees = {}
        for hw in (DISK_HW, AUG_LARGE_HW):
            root = Path(tmp) / f"{hw[0]}x{hw[1]}"
            _run_captured("native_augment", synthetic.main, [
                "--out", str(root), "--n", str(DISK_TRIPLETS), "--height",
                str(hw[0]), "--width", str(hw[1]), "--test-frac", "0.34"])
            train, test = vimeo90k.vimeo90k_splits(str(root))
            names = train + test
            frames = vimeo90k.read_frames(
                [root / "sequences" / n / f for n in names
                 for f in vimeo90k.TRIPLET])
            trees[hw] = (str(root), names,
                         [frames[j:j + 3] for j in range(0, len(frames), 3)])
        compared = 0
        for hw, (root, names, triplets) in trees.items():
            for b in AUG_BATCHES:
                ds = vimeo90k.Vimeo90KDataset(root, names, b, seed=b)
                sampler = vimeo90k.BalancedSampler(len(names), b)
                rng = np.random.RandomState(b)
                for got in ds.batches(3):
                    trips = [triplets[next(sampler)] for _ in range(b)]
                    _same_batch(got, _plain_batch(trips, _draws(trips, rng)),
                                f"{hw} B={b}")
                    compared += 1
                # the swap, each flip, and all three forced on, with the
                # crop offsets drawn
                for swap, lr, ud in ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                                     (1, 1, 1)):
                    draws = np.random.RandomState(b + hw[0])
                    recs = [(swap, oy, ox, lr, ud)
                            for _, oy, ox, _, _ in _draws(triplets[:b],
                                                          draws)]
                    _same_batch(_native_batch(triplets[:b], recs),
                                _plain_batch(triplets[:b], recs),
                                f"{hw} B={b} forced {(swap, lr, ud)}")
                    compared += 1
        print(f"[native_augment] {card}: {compared} batches bit for bit "
              f"equal to the Python path (B={list(AUG_BATCHES)}, "
              f"{DISK_HW[0]}x{DISK_HW[1]} and {AUG_LARGE_HW[0]}x"
              f"{AUG_LARGE_HW[1]} frames cropped to {H}x{W}; swap, "
              f"left-right, up-down and all three forced)")
        _, _, triplets = trees[DISK_HW]
        for b in AUG_BATCHES:
            batch = triplets[:b]
            times = {}
            for label, fn in (("native", _native_batch),
                              ("Python", _plain_batch)):
                rng = np.random.RandomState(0)
                fn(batch, _draws(batch, rng))
                times[label] = _median_s(
                    lambda: fn(batch, _draws(batch, rng)), AUG_REPS) * 1000
            print(f"[times] {card}: host augment of a B={b} batch of "
                  f"{H}x{W} triplets (decoded frames in, NCHW float32 "
                  f"tensors out; median of {AUG_REPS}, host clock): native "
                  f"{times['native']:.3f} ms on {native.thread_count()} "
                  f"threads, Python path {times['Python']:.3f} ms")


def phase_train_from_disk(dev: torch.device, step_ms: float,
                          card: str) -> None:
    """The trainer (vfidkr_torch.apps.train.main) on 18 synthetic triplets
    written by vfidkr_torch.data.synthetic and re-encoded with PIL's row
    filters: 2 epochs of 4 steps at B=3, then --resume to 3: the epoch
    seam, the Adamax step count and the plateau state carried over the
    resume, and its ms/step from disk beside the in-memory train step's;
    then, as a second reading, 2 epochs on the triplets as the port's
    writer wrote them (Up rows)."""
    with tempfile.TemporaryDirectory(prefix="vfidkr_disk_") as tmp:
        up, data, save = (Path(tmp) / n for n in ("vimeo_up", "vimeo", "run"))
        _run_captured("train_from_disk", synthetic.main, [
            "--out", str(up), "--n", str(DISK_TRIPLETS), "--height",
            str(DISK_HW[0]), "--width", str(DISK_HW[1]), "--test-frac",
            "0.34"])
        for src in sorted(up.rglob("*")):
            dst = data / src.relative_to(up)
            if src.is_dir():
                dst.mkdir(parents=True, exist_ok=True)
            elif src.suffix == ".png":
                write_pil_filtered(dst, read_png(src))
            else:
                dst.write_bytes(src.read_bytes())
        argv = _train_argv(data, save, dev)
        native.reset_calls()
        _, out_a, _ = _run_captured("train_from_disk", train_app.main,
                                    argv + ["--num-epochs", "2"])
        # every batch, train and validation, one call of the C++ augment
        want_calls = 2 * (DISK_STEPS + 1)
        print(f"[train_from_disk] the trainer's batches went through the C++ "
              f"augment: {native.CALLS} calls in 2 epochs of {DISK_STEPS} "
              f"train batches and 1 validation batch")
        if native.CALLS != want_calls:
            raise AssertionError(f"{native.CALLS} calls of the C++ augment, "
                                 f"want {want_calls}")
        first = torch.load(save / "epoch1.pth", weights_only=True)
        _, out_b, _ = _run_captured("train_from_disk", train_app.main,
                                    argv + ["--num-epochs", "3", "--resume"])
        last = torch.load(save / "epoch2.pth", weights_only=True)
        rows = np.loadtxt(save / "log.txt", delimiter=",", ndmin=2)
        read = ["--num-epochs", "2", "--steps-per-epoch",
                str(DISK_READ_STEPS)]
        readings = {}
        for label, root, run in (
                ("filtered as PIL filters them, 4 decode workers", data,
                 train_app.main),
                ("filtered as PIL filters them, decoded on the prefetch "
                 "thread", data,
                 lambda argv: train_app.train(train_app.parse_args(argv))),
                ("as the port's writer wrote them (Up rows), 4 decode "
                 "workers", up, train_app.main)):
            _, readings[label], _ = _run_captured(
                "train_from_disk", run,
                _train_argv(root, Path(tmp) / f"run{len(readings)}", dev)
                + read)
        # the apps' default: cuDNN's TF32 flag as PyTorch sets it
        label = (f"filtered as PIL filters them, 4 decode workers, "
                 f"cudnn.allow_tf32={TF32_DEFAULTS['cudnn']} (PyTorch's "
                 f"default)")
        torch.backends.cudnn.allow_tf32 = TF32_DEFAULTS["cudnn"]
        try:
            _, readings[label], _ = _run_captured(
                "train_from_disk", train_app.main,
                _train_argv(data, Path(tmp) / "run_tf32", dev) + read)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    epochs = rows[:, 0].astype(int).tolist()
    steps = {int(s["step"]) for s in last["optimizer"]["state"].values()}
    want_plateau = plateau_step(PlateauState(**first["plateau"]), rows[2, 3],
                                factor=DISK_FACTOR, patience=DISK_PATIENCE)
    print(f"[train_from_disk] log.txt epochs {epochs}, lr scales "
          f"{rows[:, 1].tolist()}; after the resume every Adamax state has "
          f"taken {sorted(steps)} steps; plateau after epoch 1 "
          f"{first['plateau']}, after epoch 2 {last['plateau']}")
    if epochs != [0, 1, 2]:
        raise AssertionError(f"epoch seam broken: {epochs}")
    if "resumed from epoch1" not in out_b:
        raise AssertionError("the second run did not resume from epoch1")
    if steps != {3 * DISK_STEPS}:
        raise AssertionError(f"Adamax steps {steps}: the resume did not "
                             f"restore the optimizer state")
    # log.txt keeps 8 decimals of the validation loss that set "best"
    got_plateau = PlateauState(**last["plateau"])
    if rows[2, 1] != first["plateau"]["scale"] or \
            got_plateau._replace(best=0.0) != want_plateau._replace(best=0.0) \
            or not math.isclose(got_plateau.best, want_plateau.best,
                                rel_tol=1e-6):
        raise AssertionError("the resume did not restore the plateau state")
    _print_disk_times("filtered as PIL filters them, 4 decode workers, "
                      "the resumed run", out_a + out_b, step_ms, card,
                      DISK_STEPS)
    for label, out in readings.items():
        _print_disk_times(label, out, step_ms, card)


def make_depth_samples(rng: np.random.RandomState) -> list:
    """Two depth-eval samples at DEPTH_HW as load_sample leaves them: a
    smooth image, a smooth depth in [0.5, 10.5] with an invalid band (mask
    0, depth 1.0), and DEPTH_SDR_PAIRS ordinal pairs."""
    h, w = DEPTH_HW
    samples = []
    for _ in range(2):
        img = np.kron(rng.rand(h // 16, w // 16, 3), np.ones((16, 16, 1)))
        depth = np.kron(rng.rand(h // 32, w // 32), np.ones((32, 32))) * 10
        mask = np.ones((h, w), np.float32)
        mask[:12] = 0.0
        gt = np.where(mask > 0, depth + 0.5, 1.0).astype(np.float32)
        sdr = {k: rng.randint(0, n, DEPTH_SDR_PAIRS)
               for k, n in (("xA", w), ("yA", h), ("xB", w), ("yB", h))}
        sdr["gt"] = rng.randint(-1, 2, DEPTH_SDR_PAIRS)
        samples.append((img.astype(np.float32), gt, mask, sdr))
    return samples


def phase_depth(dev: torch.device) -> None:
    """The depth-eval core (vfidkr_torch.apps.depth_eval.evaluate_depth) on
    MegaDepth from seed 0, two samples at 256x320, on the card and on the
    CPU: the si-RMSE within rtol 1e-4, the SDR counts equal."""
    samples = make_depth_samples(np.random.RandomState(5))
    model = MegaDepthHourglass(generator=torch.Generator().manual_seed(0))
    want = evaluate_depth(model.eval(), samples, "cpu")
    got = evaluate_depth(copy.deepcopy(model).to(dev), samples, dev)
    print(f"[depth] {DEPTH_HW[1]}x{DEPTH_HW[0]}, 2 samples: card {got}; CPU "
          f"{want}")
    if not math.isclose(got["si_rmse"], want["si_rmse"], rel_tol=1e-4) or \
            got["sdr"] != want["sdr"] or got["images"] != 2:
        raise AssertionError("depth eval: the card and the CPU disagree")
    if not 0 < got["sdr"]["total"] < 1:
        raise AssertionError("depth eval: the SDR classes are degenerate")


def phase_bf16_stages(dev: torch.device, eval_model, slowmo_model, i0, i2):
    """Where the bf16 lane's time goes, each stage on its own inputs (CUDA
    events, median of 15 after 3 warm-up): MonoNet5 and the heads, S2DF,
    and each part of the rectifier (the 7x7 conv, the K4 trunk, the 3x3
    conv to 3 channels)."""
    with torch.inference_mode():
        for tag, model, cin in (("DAIN", eval_model, 45),
                                ("slowmo", slowmo_model, 437)):
            rect = model.rectifyNet
            x = torch.rand(1, cin, H, W, device=dev)
            h1 = rect.block1(x)
            w6 = rect.trunk_weights()
            trunk = RB.fused_resblocks(h1, w6)

            def heads(m=model):
                tr = m.initScaleNets_filter(torch.cat([i0, i2], 1))
                return (m.initScaleNets_filter1(tr),
                        m.initScaleNets_filter2(tr))

            stages = [("MonoNet5 + 2 heads", heads),
                      (f"rectifier 7x7 conv {cin}->128 + ReLU",
                       lambda r=rect, x=x: r.block1(x)),
                      ("rectifier trunk (K4, 6 launches)",
                       lambda h=h1, w=w6: RB.fused_resblocks(h, w)),
                      ("rectifier 3x3 conv 128->3",
                       lambda r=rect, t=trunk: r.block5(t)),
                      ("whole rectifier", lambda r=rect, x=x: r(x))]
            if tag == "slowmo":
                frames = torch.cat([i0, i2], 0)
                stages.append(("S2DF", lambda m=model: m.ctxNet(frames)))
            for name, fn in stages:
                ms = statistics.median(cuda_times_ms(fn, 3, 15))
                print(f"[profile] bf16 {tag} stage {name}: {ms:.3f} ms")


def phase_bf16_profile(eval_model, slowmo_model, i0, i2) -> None:
    """torch.profiler over whole bf16 forwards: busy share, the largest
    device kernels, each kernel's device time a launch."""
    with torch.inference_mode():
        _profile_whole("bf16 DAIN forward", lambda: eval_model(i0, i2), 3,
                       tuple(PATHS["eval_forward_bf16"]))
        _profile_whole("bf16 slow-motion forward",
                       lambda: slowmo_model(i0, i2), 3,
                       tuple(PATHS["slowmo_forward_bf16"]))


# ---------------------------------------------------------------------------
# row sharding and data parallelism
# ---------------------------------------------------------------------------

def _plain_of_launch(name, args):
    """(kernel output, the plain version's output on the launch's own
    inputs and frame arguments) of one recorded launch."""
    if name == "flow_project_scatter":
        flow, weight, acc, _, h, _, row0, hg, _ = args
        return acc, FP.scatter4_plain(flow, weight, row0, hg)
    if name == "flow_project_finalize":
        acc, out, _, _, _, lo, hi, up, down = args
        return out, FP.finalize_plain(acc, (lo, hi), up, down)
    image, flow, filt, out = args[:4]
    row0, hg = args[8:10]
    return out, FI.filter_interpolate_plain(image, flow, filt, row0, hg)


def spatial_flow(g: torch.Generator) -> torch.Tensor:
    """make_flow at the video's padded frame, (1, 2, 768, 1344), its rows'
    reach bounded to |fy| <= SPATIAL_REACH px (the halo's contract: the rows
    are what is sharded; make_flow's |fx| is at most 24 px but on the pixels
    it pushes out of the frame sideways, which land nowhere), with a
    zero-motion island across the shard edges, whose rim leaves holes
    there."""
    h, w = VIDEO_PADDED
    flow = make_flow(g, 2, h, w)[:1]
    flow[:, 1].clamp_(-SPATIAL_REACH, SPATIAL_REACH)
    flow[:, :, 150:450, 300:700] = 0.0
    return flow.contiguous()


def phase_spatial_ops(dev: torch.device) -> dict:
    """The projection and warp chains row-sharded: (1, C, 768, 1344) in
    SPATIAL_SHARDS shards on this one card (a thread and stream a shard)
    with halo SPATIAL_HALO, |fy| <= SPATIAL_REACH.  flow_project(fill) ->
    filter_interpolate at C = 3 (K2, K3, K1), and depth_flow_project(fill)
    -> the 196-channel warp (K2 weighted, K3, K7).  Each chain's offsets
    are held to the chain's unsharded on the card, its frame to the
    unsharded warp of its offsets (ATOL, see _compare), each sharded launch
    to its plain version on the same inputs and frame arguments (K3 bit for
    bit), and the launches are counted exactly.  Returns the launches."""
    from vfidkr_torch.parallel.spatial import spatial_shard_fn
    g = torch.Generator().manual_seed(11)
    h, w = VIDEO_PADDED
    flow = spatial_flow(g).to(dev)
    image = torch.rand(1, 3, h, w, generator=g).to(dev)
    ctx = torch.rand(1, C_CTX, h, w, generator=g).to(dev)
    filt = torch.randn(1, 16, h, w, generator=g).to(dev)
    depth_inv = (1e-6 + torch.exp(-(torch.rand(1, 1, h, w, generator=g) * 4
                                    - 1))).to(dev)

    def chain(image, flow, filt):
        offs = FP.flow_project(flow, hole_fill=True)
        return offs, FI.filter_interpolate(image, offs, filt)

    def depth_chain(ctx, flow, filt, depth_inv):
        offs = FP.depth_flow_project(flow, depth_inv, hole_fill=True)
        return offs, FI.filter_interpolate(ctx, offs, filt)

    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    shards = [dev] * SPATIAL_SHARDS
    for label, fn, ins in (("K2 K3 K1 C=3", chain, (image, flow, filt)),
                           ("K2 weighted, K3, K7 C=196", depth_chain,
                            (ctx, flow, filt, depth_inv))):
        sharded = spatial_shard_fn(fn, shards, SPATIAL_HALO)
        with torch.inference_mode():
            want = fn(*ins)
            torch.cuda.synchronize()
            kernels.reset_launches()
            with kernels.record_launches() as records:
                got = sharded(*ins)
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
        kinds = [n for n, _ in records]
        print(f"[spatial_ops] {label}: {len(records)} launches in "
              f"{SPATIAL_SHARDS} shards: {counts}")
        for name, n in counts.items():
            if n != kinds.count(name):
                raise AssertionError(f"{name}: {n} counted, "
                                     f"{kinds.count(name)} recorded")
            launches[name] += n
        _compare(f"spatial {label} offsets, sharded vs unsharded", got[0],
                 want[0])
        # the frame against the unsharded warp of the sharded offsets: the
        # offsets' last bits (K2's atomic sums in any order) move a warp
        # with random filters by up to ~4e-4, sharded or not
        with torch.inference_mode():
            warp = FI.filter_interpolate(ins[0], got[0], ins[2])
            drift = (got[1] - want[1]).abs().max().item()
        _compare(f"spatial {label} frame, sharded vs the unsharded warp of "
                 f"its offsets", got[1], warp)
        print(f"[spatial_ops] {label} frame against the unsharded chain's "
              f"(whose offsets differ in their last bits): max |diff| "
              f"{drift:.3e} (not bounded)")
        row0s = set()
        with torch.inference_mode():
            for k, (name, args) in enumerate(records):
                kout, plain = _plain_of_launch(name, args)
                tag = f"spatial {name} launch {k}"
                if name == "flow_project_finalize":
                    if not torch.equal(kout, plain):
                        raise AssertionError(
                            f"{tag}: K3 not bit-equal to its plain version "
                            f"({(kout != plain).sum().item()} values)")
                    print(f"[kernels] {tag} (interior rows {args[5]}.."
                          f"{args[6]}, carries given): equal to the plain "
                          f"version, bit for bit")
                else:
                    row0 = args[6] if name == "flow_project_scatter" \
                        else args[8]
                    row0s.add(row0)
                    tag += f" (row0 {row0})"
                    _compare(tag, kout, plain)
                    if name == "flow_project_scatter" and args[1] is None \
                            and not torch.equal(kout[:, 2], plain[:, 2]):
                        raise AssertionError(f"{tag}: the count differs")
        if not any(r < 0 for r in row0s) or not any(r > 0 for r in row0s):
            raise AssertionError(f"no shard with row0 < 0 and > 0: {row0s}")
        # host wall times, the card synchronised (each already run once)
        with torch.inference_mode():
            t_one, t_sh = (1000 * _median_s(
                lambda f=f: (f(*ins), torch.cuda.synchronize()), 5)
                for f in (fn, sharded))
        print(f"[times] spatial_ops {label} at 1x{h}x{w}: unsharded "
              f"{t_one:.3f} ms, {SPATIAL_SHARDS} shards of "
              f"{h // SPATIAL_SHARDS + 2 * SPATIAL_HALO} rows on one card "
              f"{t_sh:.3f} ms (host wall, median of 5)")
    _check_launches("spatial_ops", launches)
    return launches


def phase_spatial_video(dev: torch.device) -> dict:
    """The video driver's sharded forward (interpolate_video.sharded_forward,
    frames_between) of DAINSlowMotion(0.25) on the video phase's 1280x720
    clip, VIDEO_SHARDS shards of the one card with halo VIDEO_HALO: frames
    padded by the sharded rule (to 1408x768), the launches counted exactly,
    the frames finite, frames/s, peak memory in all (both shards on this
    card) and a shard's (the same forward on one shard's block alone, as one
    card of a sharded run holds it), and the PSNR of each synthesised frame
    against the unsharded forward on the same padded frames (reported, not
    bounded: the tiled forward is JAX's stated approximation).  Returns the
    launches."""
    frames = make_clip(torch.Generator().manual_seed(1), VIDEO_FRAMES,
                       VIDEO_H, VIDEO_W)
    model = make_slowmo_model().to(dev).eval()
    shards = [dev] * VIDEO_SHARDS
    sharded = interpolate_video.sharded_forward(model, VIDEO_SHARDS,
                                                VIDEO_HALO, shards)
    inputs = [interpolate_video.to_input(f, dev, VIDEO_SHARDS)
              for f in frames]
    padded = tuple(inputs[0][0].shape[2:])
    local = padded[0] // VIDEO_SHARDS + 2 * VIDEO_HALO
    print(f"[spatial_video] {VIDEO_W}x{VIDEO_H} padded by the sharded rule "
          f"{interpolate_video.pad_rule(VIDEO_SHARDS)} to {padded[1]}x"
          f"{padded[0]}; {VIDEO_SHARDS} shards of {local} rows")

    def run(fwd):
        return [interpolate_video.frames_between(fwd, a[0], b[0], a[1])
                for a, b in zip(inputs[:-1], inputs[1:])]

    with torch.inference_mode():
        # a warm-up, its frames before the 8-bit rounding held finite
        for x in sharded(inputs[0][0], inputs[1][0])["outputs"][1]:
            if not bool(torch.isfinite(x).all()):
                raise AssertionError("spatial_video: non-finite frames")
        run(sharded)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t = time.perf_counter()
        got = run(sharded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t = time.perf_counter()
        want = run(model)
        torch.cuda.synchronize()
        wall_one = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        run(model)
        peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[spatial_video] launches: {launches}")
    _check_launches("spatial_video", launches)

    # a shard's peak: the same forward on one shard's block alone (its rows
    # and halo), as one card of a sharded run holds it
    with torch.inference_mode():
        block = [x[0][:, :, :local] for x in inputs[:2]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model(*block)
        torch.cuda.synchronize()
        shard_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    psnrs = []
    for a, b in zip(got, want):
        if tuple(a.shape) != (round(1 / SLOWMO_T) - 1, VIDEO_H, VIDEO_W, 3):
            raise AssertionError(f"spatial_video: frames {tuple(a.shape)}")
        mse = ((a.float() - b.float()) / 255).pow(2).mean(dim=(1, 2, 3))
        psnrs += [-10 * math.log10(m) if m > 0 else math.inf
                  for m in mse.tolist()]
    n_out = VIDEO_PAIRS * (round(1 / SLOWMO_T) - 1)
    print(f"[times] spatial_video DAINSlowMotion({SLOWMO_T}) float32 at "
          f"{padded[1]}x{padded[0]}, {VIDEO_PAIRS} pairs, {n_out} frames: "
          f"{VIDEO_SHARDS} shards on one card {n_out / wall:.4f} frames/s "
          f"(wall {wall:.3f} s), unsharded {n_out / wall_one:.4f} frames/s "
          f"(wall {wall_one:.3f} s), forwards and 8-bit frames only, no "
          f"PNG; peak memory {peak:.3f} GiB in all with {VIDEO_SHARDS} "
          f"shards ({held:.3f} GiB held before), {peak_one:.3f} GiB "
          f"unsharded; a shard's peak (the forward on one {padded[1]}x"
          f"{local} block alone) {shard_peak:.3f} GiB, "
          f"{shard_peak / (local * padded[1] / 1e6):.3f} GiB a megapixel")
    finite = [p for p in psnrs if math.isfinite(p)]
    print(f"[spatial_video] the sharded frames against the unsharded "
          f"forward's: PSNR min {min(psnrs):.2f} dB, mean of the finite "
          f"{statistics.fmean(finite) if finite else math.inf:.2f} dB, "
          f"{len(psnrs) - len(finite)} of {len(psnrs)} frames equal (not "
          f"bounded: the tiled approximation)")
    return launches


def _hold_grads(tag, grads: dict, plain) -> float:
    """``plain``'s gradients against ``grads`` (name -> the data-parallel
    gradient), per leaf, within rtol 5e-3 and atol 5e-3 x the leaf's largest
    magnitude (the train phases' tolerance); then ``grads`` copied into
    ``plain``.  Returns the worst max |diff| / the leaf's largest
    magnitude."""
    worst = 0.0
    for name, q in plain.named_parameters():
        if q.grad is None:
            continue
        got = grads[name].to(q.device)
        scale = max(q.grad.abs().max().item(), 1e-12)
        worst = max(worst, (got - q.grad).abs().max().item() / scale)
        if not torch.allclose(got, q.grad, rtol=5e-3, atol=5e-3 * scale):
            raise AssertionError(f"{tag}: the gradients of {name} disagree")
        q.grad.copy_(got)
    return worst


def phase_data_parallel(dev: torch.device) -> dict:
    """The trainer's data-parallel path (vfidkr_torch.parallel.mesh) over a
    process group of world size 1 on NCCL (in this process, a file store):
    DP_STEPS DAIN train steps at B=3, 256x448, each rank's share of the
    batch, the gradients all-reduced before Adamax and the metrics averaged,
    each against the one-process trainer's step from the same state (the
    plain model and its Adamax state set to the data-parallel ones first)
    on the same batch: the loss (rtol 1e-4) and the gradients per leaf
    (rtol 5e-3, atol 5e-3 x the leaf's largest magnitude, the train phases'
    tolerance); then the one-process Adamax step, on the data-parallel
    gradients, gives the data-parallel parameters bit for bit.  The two
    runs' own parameters are not compared element by element: Adamax moves
    a weight whose gradient is near its eps (1e-8) by lr x g / (|g| + eps),
    so the gradients' last bits (K2's atomics, the warps' backward on
    ATen's atomics) can flip such a weight's step (3 steps of the two runs
    from the same init put 2 values of initScaleNets_filter.11.weight past
    the tolerance above).  With two or more cards also world size 2 (one
    process a card).  Returns the launches of the data-parallel steps."""
    import torch.distributed as dist
    from vfidkr_torch.parallel import mesh as M
    config = TrainConfig()
    g = torch.Generator().manual_seed(7)
    batches = [{k: v.to(dev) for k, v in make_triplets(g, TRAIN_B).items()}
               for _ in range(DP_STEPS)]
    plain = make_model().to(dev)
    dp = copy.deepcopy(plain)
    plain_opt, dp_opt = make_optimizer(plain, config), make_optimizer(dp,
                                                                      config)
    worst = 0.0
    with tempfile.TemporaryDirectory(prefix="vfidkr_dp_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = M.create_mesh(dev)
            if not mesh.joined or mesh.world != 1:
                raise AssertionError(f"mesh {mesh}")
            M.replicate(dp, mesh)
            launches = dict.fromkeys(kernels.LAUNCHES, 0)
            for step, batch in enumerate(batches):
                # a copy: loading keeps the tensors it is given, and the
                # data-parallel step updates its state in place
                plain.load_state_dict(dp.state_dict())
                plain_opt.load_state_dict(copy.deepcopy(dp_opt.state_dict()))
                kernels.reset_launches()
                m = M.mean_across(train_step(
                    dp, dp_opt, M.shard_batch(batch, mesh), config, 1.0,
                    lambda model: M.average_gradients(model, mesh)), mesh)
                torch.cuda.synchronize()
                counts = dict(kernels.LAUNCHES)
                _check_launches("train_step", counts)
                for k in launches:
                    launches[k] += counts[k]
                tag = f"data_parallel step {step}"

                grads = {n: p.grad for n, p in dp.named_parameters()
                         if p.grad is not None}

                def swap(model, tag=tag, grads=grads):
                    nonlocal worst
                    worst = max(worst, _hold_grads(tag, grads, model))

                want = train_step(plain, plain_opt, batch, config, 1.0, swap)
                a, b = float(m["total"]), float(want["total"])
                print(f"[data_parallel] step {step}: loss {a:.6f} through "
                      f"the NCCL group, {b:.6f} one process")
                if not math.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                    raise AssertionError(f"{tag}: loss {a} vs {b}")
                for (name, p), q in zip(dp.named_parameters(),
                                        plain.parameters()):
                    if not torch.equal(p, q):
                        raise AssertionError(f"{tag}: Adamax on the same "
                                             f"gradients moved {name} "
                                             f"differently")
        finally:
            dist.destroy_process_group()
    _check_launches("data_parallel", launches)
    print(f"[data_parallel] {DP_STEPS} steps through the world-size-1 NCCL "
          f"group: losses and gradients those of the one-process steps "
          f"(worst max |diff| / the leaf's largest gradient {worst:.3e}), "
          f"the parameters the one-process Adamax step's on its gradients "
          f"bit for bit; launches {launches}")
    if torch.cuda.device_count() >= 2:
        _data_parallel_two_cards()
    else:
        print("[data_parallel] one card: world size 2 not run")
    return launches


def _dp_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the two-card data-parallel check (started by
    _data_parallel_two_cards): one step on its share of a global batch of
    2 x world, its parameters written by rank 0."""
    import torch.distributed as dist
    from vfidkr_torch.parallel import mesh as M
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = M.Mesh(rank, world, dev, True)
        model = make_model().to(dev)
        opt = make_optimizer(model, TrainConfig())
        M.replicate(model, mesh)
        batch = make_triplets(torch.Generator().manual_seed(7), 2 * world)
        train_step(model, opt, M.shard_batch(batch, mesh), TrainConfig(),
                   1.0, lambda m: M.average_gradients(m, mesh))
        if rank == 0:
            torch.save({"grads": {n: p.grad.cpu() for n, p in
                                  model.named_parameters()
                                  if p.grad is not None},
                        "params": {n: p.detach().cpu() for n, p in
                                   model.named_parameters()}}, out)
    finally:
        dist.destroy_process_group()


def _data_parallel_two_cards() -> None:
    """World size 2 on cards 0 and 1, one process each, against one process
    on card 0 with the whole batch, one step held as phase_data_parallel
    holds each of its steps."""
    import torch.multiprocessing as mp
    world = 2
    with tempfile.TemporaryDirectory(prefix="vfidkr_dp2_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.spawn(_dp_rank, args=(world, os.path.join(tmp, "store"), out),
                 nprocs=world, join=True)
        got = torch.load(out, weights_only=True)
    dev = torch.device("cuda", 0)
    model = make_model().to(dev)
    opt = make_optimizer(model, TrainConfig())
    batch = {k: v.to(dev) for k, v in make_triplets(
        torch.Generator().manual_seed(7), 2 * world).items()}
    worst = []
    train_step(model, opt, batch, TrainConfig(), 1.0, lambda m: worst.append(
        _hold_grads("data_parallel world 2", got["grads"], m)))
    for name, p in model.named_parameters():
        if not torch.equal(p.detach().cpu(), got["params"][name]):
            raise AssertionError(f"data_parallel world 2: Adamax on the "
                                 f"same gradients moved {name} differently")
    print(f"[data_parallel] world size 2 run on cards 0 and 1 (NCCL, one "
          f"process each): a step at B={2 * world}, its gradients those of "
          f"the one-process step (worst {worst[0]:.3e}), its parameters the "
          f"one-process Adamax step's on them")


def dormant_cases(g: torch.Generator) -> list:
    """(name, op, CPU inputs, differentiable inputs, exact) of each dormant
    op at the DAIN cell's width: both directions of phase 3's frames, a
    make_flow draw, softmaxed 4x4 filters, offsets within DORMANT_OFFSET,
    an inverse depth near 1 with ties, and softmaxed 16-tap separable
    filters with bands that sum to exactly 0 (the -2000 sentinel)."""
    image = torch.cat(make_frames(g))
    flow = make_flow(g, N, H, W)
    filt = torch.softmax(torch.randn(N, 16, H, W, generator=g), 1)
    offsets = (torch.rand(N, 32, H, W, generator=g) * 2 - 1) * DORMANT_OFFSET
    depth = 1 + torch.randint(0, DEPTH_LEVELS, (N, H, W), generator=g) / 256
    ho, wo = H - SEP_TAPS + 1, W - SEP_TAPS + 1
    vert, horiz = (torch.softmax(torch.randn(N, SEP_TAPS, ho, wo,
                                             generator=g), 1)
                   for _ in range(2))
    vert[:, :, :8] = 0.0
    horiz[:, :, :, :8] = 0.0
    deform = lambda q: (lambda *a: OPS.filter_interpolate_deformable(*a, q))
    return [
        ("filter_interpolate_deformable static", deform("static"),
         [image, flow, filt, offsets], (0, 1, 2, 3), False),
        ("filter_interpolate_deformable deformed", deform("deformed"),
         [image, flow, filt, offsets], (0, 1, 2, 3), False),
        ("filter_interpolate_nofilter_deformable",
         OPS.filter_interpolate_nofilter_deformable, [image, flow, offsets],
         (0, 1, 2), False),
        ("interpolate_bilinear", OPS.interpolate_bilinear, [image, flow],
         (0, 1), False),
        ("min_depth_flow_project", OPS.min_depth_flow_project, [flow, depth],
         (0,), True),
        ("min_depth_flow_project hole_fill",
         lambda f, d: OPS.min_depth_flow_project(f, d, hole_fill=True),
         [flow, depth], (0,), True),
        ("separable_conv", OPS.separable_conv, [image, vert, horiz],
         (0, 1, 2), False),
        ("separable_conv_flow", OPS.separable_conv_flow, [vert, horiz],
         (0, 1), False)]


def phase_dormant_ops(dev: torch.device, card: str) -> dict:
    """The reference's dormant ops (plain PyTorch on every device) on the
    card and on the CPU at 2x3x256x448: each forward within ATOL x max(1,
    |CPU|) (min_depth_flow_project bit for bit: a max and an integer
    tie-break have no order), each differentiable input's gradient under a
    random cotangent within ATOL x max(1, max |CPU gradient|), and no kernel
    of the port launched; each op's forward ms a call (CUDA events, median
    of 20 after 3 warm-up).  Returns the launches."""
    g = torch.Generator().manual_seed(11)
    cases = dormant_cases(g)
    kernels.reset_launches()
    for name, fn, inputs, which, exact in cases:
        gpu = [x.to(dev) for x in inputs]
        with torch.no_grad():
            got, want = fn(*gpu), fn(*inputs)
        torch.cuda.synchronize()
        diff = (got.cpu() - want).abs()
        scaled = (diff / want.abs().clamp(min=1.0)).max().item()
        same = torch.equal(got.cpu(), want)
        print(f"[dormant_ops] {name} {tuple(got.shape)}: forward max |card - "
              f"CPU| = {diff.max().item():.3e}, scaled by max(1, |CPU|) = "
              f"{scaled:.3e}, bit-equal {same} (tolerance "
              f"{'bit-equal' if exact else f'{ATOL:.0e}'})")
        if not (same if exact else scaled <= ATOL):
            raise AssertionError(f"dormant_ops {name}: the card and the CPU "
                                 f"disagree")
        if name == "separable_conv_flow":
            sentinel = int((want == -2000.0).sum())
            if not sentinel or not torch.equal(got.cpu() == -2000.0,
                                               want == -2000.0):
                raise AssertionError("separable_conv_flow: the sentinel")
            print(f"[dormant_ops] {name}: {sentinel} sentinel values, the "
                  f"same cells on both")
        cot = torch.randn(want.shape, generator=g)
        for i, a, b in zip(which, _grads(fn, gpu, cot.to(dev), which),
                           _grads(fn, inputs, cot, which)):
            err = (a.cpu() - b).abs().max().item()
            tol = ATOL * max(1.0, b.abs().max().item())
            print(f"[dormant_ops] {name} gradient of input {i}: max |card - "
                  f"CPU| = {err:.3e} (tolerance {tol:.3e} = {ATOL:.0e} x "
                  f"max(1, max |CPU|))")
            if not err <= tol:
                raise AssertionError(f"dormant_ops {name} gradient {i}: "
                                     f"{err} exceeds {tol}")
        with torch.no_grad():
            t = cuda_times_ms(lambda: fn(*gpu), warmup=3, iters=20)
        print(f"[times] dormant_ops {name} at {tuple(gpu[0].shape)}: "
              f"{statistics.median(t):.3f} ms a call (CUDA events, median of "
              f"{len(t)} after 3 warm-up; min {t[0]:.3f}, max {t[-1]:.3f}) "
              f"on {card}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _check_launches("dormant_ops", launches)
    print(f"[dormant_ops] launches of the port's kernels: {launches}")
    return launches


def _vestigial_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.startswith(VESTIGIAL)}


def phase_vestigial(dev: torch.device, card: str) -> dict:
    """DAIN(init_unused=True) (phase 3's model) on the card: one 448x256
    eval forward launches K1, K2 and K3 once each; its outputs equal
    DAIN(init_unused=False) loaded with the shared weights bit for bit
    (K2 summed on the host and cuDNN deterministic, run_to_run_stable); its
    reference-layout state dict, saved and read back, loads into a fresh
    DAIN with strict=True; one train step leaves the three vestigial
    children unchanged.  Returns the eval forward's launches."""
    t0 = time.perf_counter()
    full = make_model().eval().to(dev)
    lean = DAIN(generator=torch.Generator().manual_seed(0),
                init_unused=False)
    lean.load_state_dict({k: v for k, v in full.state_dict().items()
                          if not k.startswith(VESTIGIAL)}, strict=True)
    lean = lean.eval().to(dev)
    i0, i2 = (x.to(dev) for x in make_frames(torch.Generator().manual_seed(1)))
    with torch.inference_mode():
        kernels.reset_launches()
        full(i0, i2)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    _check_launches("vestigial_eval", launches)
    with torch.inference_mode(), run_to_run_stable():
        a, b = full(i0, i2), lean(i0, i2)
    pairs = [(f"{key}[{k}]", x, y) for key in ("outputs", "offsets",
                                                "filters")
             for k, (x, y) in enumerate(zip(a[key], b[key]))]
    unequal = [name for name, x, y in pairs if not torch.equal(x, y)]
    print(f"[vestigial] DAIN(init_unused=True) eval {W}x{H}: launches "
          f"{launches}; its {len(pairs)} outputs against "
          f"DAIN(init_unused=False) with the shared weights, K2 summed on "
          f"the host and cuDNN deterministic: bit-equal "
          f"{len(pairs) - len(unequal)} of {len(pairs)}")
    if unequal:
        raise AssertionError(f"init_unused changes the outputs: {unequal}")

    with tempfile.TemporaryDirectory(prefix="vfidkr_vestigial_") as tmp:
        path = Path(tmp) / "dain_reference.pth"
        torch.save({k: v.cpu() for k, v in reference_state_dict(full).items()},
                   path)
        sd = torch.load(path, map_location="cpu", weights_only=True)
    # PWC-Net's deconv2, which nothing calls, is the one reference key that
    # no port model holds
    for key in ("flownets.deconv2.weight", "flownets.deconv2.bias"):
        del sd[key]
    again = DAIN(init_unused=True)
    again.load_state_dict(sd, strict=True)
    same = all(torch.equal(v, sd[k]) for k, v in again.state_dict().items())
    n_vest = sum(k.startswith(VESTIGIAL) for k in sd)
    print(f"[vestigial] the reference-layout state dict ({len(sd)} tensors, "
          f"{n_vest} of them {', '.join(VESTIGIAL)}'s) loads into DAIN() "
          f"with strict=True, every tensor equal: {same}")
    if not same or not n_vest:
        raise AssertionError("the strict reload differs")
    del full, lean, again

    model = make_model().to(dev)
    opt = make_optimizer(model, TrainConfig())
    before = _vestigial_state(model)
    batch = {k: v.to(dev) for k, v in
             make_triplets(torch.Generator().manual_seed(2), 1).items()}
    kernels.reset_launches()
    m = train_step(model, opt, batch, TrainConfig())
    torch.cuda.synchronize()
    _check_launches("train_step", dict(kernels.LAUNCHES))
    after = _vestigial_state(model)
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    no_grad = all(p.grad is None for c in VESTIGIAL
                  for p in getattr(model, c).parameters())
    print(f"[vestigial] one train step (loss {float(m['total']):.6f}): the "
          f"{len(before)} vestigial tensors unchanged: {not moved}, no "
          f"gradient: {no_grad}; the phase took "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    if moved or not no_grad or not math.isfinite(float(m["total"])):
        raise AssertionError(f"the train step moved {moved}")
    return launches


def png_frames(g: torch.Generator) -> list:
    """(label, PNG bytes, the RGB frame PIL's .convert("RGB") gives) of four
    1280x720 frames of a smooth scene, built by hand (tests/torch_png.py),
    each row filtered as PIL's encoder filters it: 16-bit RGB, 16-bit gray
    (PIL clips it to 255), 8-bit RGB Adam7-interlaced and a 4-bit palette."""
    scene = make_clip(g, 1, VIDEO_H, VIDEO_W)[0]
    noise = torch.randint(0, 256, scene.shape, generator=g).numpy()
    rgb16 = scene.astype(np.uint16) * 256 + noise.astype(np.uint16)
    gray16 = scene[..., :1].astype(np.uint16) * 2
    index = scene[..., 1:2] >> 4
    palette = torch.randint(0, 256, (16, 3), generator=g).numpy()
    grey = lambda x: np.repeat(x, 3, axis=-1).astype(np.uint8)
    return [
        ("16-bit RGB", torch_png.encode(rgb16, "pil", depth=16),
         (rgb16 >> 8).astype(np.uint8)),
        ("16-bit gray", torch_png.encode(gray16, "pil", depth=16),
         grey(np.minimum(gray16, 255))),
        ("Adam7 8-bit RGB", torch_png.encode(scene, "pil", interlace=True),
         scene),
        ("4-bit palette", torch_png.encode(index, "pil", depth=4,
                                           palette=palette),
         palette[index[..., 0]].astype(np.uint8))]


def phase_trace(dev: torch.device, card: str) -> None:
    """vfidkr_torch.utils.trace around a DAIN eval forward on the card: its
    Chrome trace holds the card's kernels, K1-K3 among them (run last: a
    profiler session slows host-bound timings after it)."""
    from vfidkr_torch.utils import trace
    model = DAIN(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x0, x1 = (torch.rand(1, 3, H, W, device=dev) for _ in range(2))
    with tempfile.TemporaryDirectory(prefix="vfidkr_trace_") as tmp:
        t0 = time.perf_counter()
        with torch.inference_mode(), trace(tmp):
            model(x0, x1)
            torch.cuda.synchronize()
        section_s = time.perf_counter() - t0
        files = list(Path(tmp).glob("*.pt.trace.json"))
        events = json.loads(files[0].read_text())["traceEvents"]
    kernels_seen = {e.get("name", "") for e in events
                    if e.get("cat") == "kernel"}
    ours = {k: any(f"{k}_kernel" in n for n in kernels_seen)
            for k in ("filter_interpolate_fwd", "flow_project_scatter",
                      "flow_project_finalize")}
    print(f"[trace] {card}: utils.trace wrote {files[0].name} with "
          f"{len(kernels_seen)} distinct device kernels; K1-K3 among them: "
          f"{ours}; the section took {section_s * 1000:.1f} ms with "
          f"the profiler on")
    if not all(ours.values()):
        raise AssertionError(f"the trace lacks device events of K1-K3: "
                             f"{ours}")


def phase_png_depths(dev: torch.device, card: str) -> None:
    """The PNG formats past 8-bit plain (no PIL on the card's machine):
    four 1280x720 frames written by hand, read back by read_rgb and held
    to the expected frames exactly, each read's host ms (median of 3); then
    the depth-eval CLI (vfidkr_torch.apps.depth_eval.main) on the card on
    one 16-bit Adam7 480x640 PNG with an .sdr.npz sample, resized to
    256x320 by the numpy resize."""
    g = torch.Generator().manual_seed(12)
    with tempfile.TemporaryDirectory(prefix="vfidkr_png_") as tmp:
        tmp = Path(tmp)
        for label, data, want in png_frames(g):
            path = tmp / "frame.png"
            path.write_bytes(data)
            got = read_rgb(path)
            if not np.array_equal(got, want):
                raise AssertionError(f"png_depths {label}: read_rgb differs "
                                     f"from the expected frame")
            t = _median_s(lambda: read_rgb(path))
            print(f"[png_depths] read_rgb of a {VIDEO_W}x{VIDEO_H} {label} "
                  f"PNG ({len(data)} bytes): equal to the expected frame; "
                  f"{t * 1000:.3f} ms a frame (median of 3, host clock) on "
                  f"{card}'s host")
        h, w = 480, 640
        low = torch.rand(h // 16 + 1, w // 16 + 1, 3, generator=g).numpy()
        img = (np.kron(low, np.ones((16, 16, 1)))[:h, :w] * 65535).astype(
            np.uint16)
        (tmp / "sample.png").write_bytes(torch_png.encode(
            img, "pil", depth=16, interlace=True))
        dh, dw = DEPTH_HW
        pairs = {k: torch.randint(0, n, (DEPTH_SDR_PAIRS,),
                                  generator=g).numpy()
                 for k, n in (("xA", dw), ("yA", dh), ("xB", dw), ("yB", dh))}
        pairs["gt"] = torch.randint(-1, 2, (DEPTH_SDR_PAIRS,),
                                    generator=g).numpy()
        np.savez(tmp / "sample.sdr.npz", **pairs)
        t0 = time.perf_counter()
        result, _, _ = _run_captured("png_depths", depth_eval.main, [
            "--data-root", str(tmp), "--input-height", str(dh),
            "--input-width", str(dw), "--device", str(dev)])
        took = time.perf_counter() - t0
    sdr = result.get("sdr", {})
    print(f"[png_depths] the depth-eval CLI on a {w}x{h} 16-bit Adam7 PNG "
          f"resized to {dw}x{dh}: {result}; {took:.2f} s (host clock, "
          f"MegaDepth built and run once) on {card}")
    if result.get("images") != 1 or sdr.get("pairs") != DEPTH_SDR_PAIRS \
            or not 0 < sdr.get("total", 0) < 1:
        raise AssertionError(f"the depth-eval CLI: {result}")


def make_sepconv_model(dev) -> torch.nn.Module:
    """SepConv built by ``ModelConfig`` (which turns cuDNN's autotuner on)
    with the SepConv cell's weights from seed 0, in eval mode."""
    config = load_json(Path(__file__).resolve().parent / "benchmark" /
                       "configs" / "sepconv.json")
    with torch.device("meta"):
        model = ModelConfig("SepConv").build()
    state = make_state(shapes_of(model), config, 0, dev)
    model = model.to_empty(device=dev)
    model.load_state_dict(state, strict=True)
    return model.eval()


def _k9_inputs(n, h, w, dev):
    g = torch.Generator(device=dev).manual_seed(h * w)
    i0, i2 = torch.rand(2, n, 3, h, w, generator=g, device=dev)
    v1, h1, v2, h2 = (torch.rand(4, n, SC.K9_TAPS, h, w, generator=g,
                                 device=dev) - 0.2) * 0.04
    return i0, v1, h1, i2, v2, h2


def _compare_k9(shape, args) -> float:
    """K9 against its plain version in float64: each value's error over the
    float64 sum of its terms' magnitudes (the plain version on |filters|,
    the frames being positive) at most K9_TOL; two launches bit for bit.
    Returns max |kernel - float64|."""
    with torch.inference_mode():
        got = SC.separable_conv_pair(*args)
        again = SC.separable_conv_pair(*args)
        d = [t.double() for t in args]
        want = SC.separable_conv_pair_plain(*d)
        mag = SC.separable_conv_pair_plain(d[0], d[1].abs(), d[2].abs(),
                                           d[3], d[4].abs(), d[5].abs())
    err = (got.double() - want).abs()
    rel = (err / mag).max().item()
    same = torch.equal(got, again)
    print(f"[kernels] sepconv_pair K9 {shape}: error over the sum of |terms| "
          f"{rel:.3e} against float64 (tolerance {K9_TOL:.0e}); max |kernel "
          f"- float64| {err.max().item():.3e}; two launches "
          f"{'bit-equal' if same else 'DIFFER'}")
    if not (rel <= K9_TOL and same):
        raise AssertionError(f"sepconv_pair {shape}: failed its check")
    return err.max().item()


def phase_sepconv(dev: torch.device, card: str) -> tuple[dict, dict]:
    """SepConv on the card against the CPU, the video driver's per-pair path
    at 1080p with K9's launches counted, and K9 against float64 and timed.
    Returns (the path's launches of the port's kernels, K9's row of the
    kernels line)."""
    saved = torch.backends.cudnn.benchmark
    try:
        model = make_sepconv_model(dev)
        if not torch.backends.cudnn.benchmark:
            raise AssertionError("ModelConfig('SepConv').build() left "
                                 "cuDNN's autotuner off")
        g = torch.Generator().manual_seed(19)
        h, w = SEPCONV_CPU_HW
        i0, i2 = make_frames(g, h, w)
        with torch.inference_mode():
            out = model(i0.to(dev), i2.to(dev))["outputs"][-1]
            ref = copy.deepcopy(model).cpu()(i0, i2)["outputs"][-1]
        _hold_to_cpu("sepconv", [(f"out {h}x{w}", out, ref,
                                  SEPCONV_CPU_ATOL)])

        h, w = SEPCONV_HW
        clip = make_clip(g, SEPCONV_PAIRS + 1, h, w)
        kernels.reset_launches()
        times, clamped = [], []
        a_in, pads = interpolate_video.to_input(clip[0], dev)
        for k in range(SEPCONV_PAIRS):
            t = time.perf_counter()
            b_in, _ = interpolate_video.to_input(clip[k + 1], dev)
            frames = interpolate_video.frames_between(model, a_in, b_in,
                                                      pads).cpu()
            times.append(time.perf_counter() - t)
            if tuple(frames.shape) != (1, h, w, 3) or \
                    frames.dtype != torch.uint8:
                raise AssertionError(f"sepconv frames {tuple(frames.shape)}"
                                     f" {frames.dtype}")
            if tuple(b_in.shape[2:]) != SEPCONV_PADDED:
                raise AssertionError(f"padded to {tuple(b_in.shape[2:])}")
            clamped.append((frames == 0).float().mean().item() +
                           (frames == 255).float().mean().item())
            a_in = b_in
        launches = dict(kernels.LAUNCHES)
        print(f"[sepconv] the video driver's path, {SEPCONV_PAIRS} pairs at "
              f"{w}x{h} run at {SEPCONV_PADDED[1]}x{SEPCONV_PADDED[0]}: "
              f"launches {launches}; frames "
              f"(1, {h}, {w}, 3) uint8, {max(clamped):.2e} of the values at "
              f"0 or 255 at most; host s a pair (first one tunes cuDNN): "
              f"{[round(x, 4) for x in times]} on {card}")
        _check_launches("sepconv_video", launches)
        del model, a_in, b_in
    finally:
        torch.backends.cudnn.benchmark = saved

    row = None
    for n, h, w in K9_SHAPES:
        args = _k9_inputs(n, h, w, dev)
        err = _compare_k9((n, 3, h, w), args)
        with torch.inference_mode():
            call = statistics.median(cuda_times_ms(
                lambda: SC.separable_conv_pair(*args)))
            plain = statistics.median(cuda_times_ms(
                lambda: SC.separable_conv_pair_plain(*args), warmup=1,
                iters=3))
        bound = bound_s(n, 3, h, w, SC.K9_TAPS) * 1e3
        print(f"[times] K9 ({n},3,{h},{w}) (sepconv_pair): per call "
              f"{call:.4f} ms with the wrapper (CUDA events, median of 50), "
              f"plain {plain:.1f} ms (median of 3); bound {bound:.4f} ms by "
              f"operations: {bound / call:.1%} of it, on {card}")
        if row is None:
            row = {"name": "sepconv_pair", "route": "cuda",
                   "source": "vfidkr_torch/csrc/sepconv_pair.cu",
                   "replaces": "vfidkr_tpu/ops/separable_conv.py:26 (static "
                               "slices, twice, summed)",
                   "case": f"K9 {(n, 3, h, w)}", "max_abs_err": err,
                   "call_ms": call, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": "operations", "other_cases": []}
        else:
            row["other_cases"].append({
                "case": f"K9 {(n, 3, h, w)}", "max_abs_err": err,
                "call_ms": call, "plain_ms": plain, "bound_ms": bound,
                "bound_by": "operations"})
        del args
    torch.cuda.synchronize()
    return launches, row


def _dense_inputs(n, h, w, od, seed):
    """A level's input in [-1, 1), its five convs' weights at the init's
    scale (normal, std sqrt(2 / (9 Cin))) and biases of +-0.01, on the
    card."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, od, h, w, generator=g) * 2 - 1
    ws, bs, cin = [], [], od
    for cout in DENSE:
        ws.append(torch.randn(cout, cin, 3, 3, generator=g)
                  * (2.0 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=g) * 0.01)
        cin += cout
    dev = torch.device("cuda")
    return x.to(dev), [t.to(dev) for t in ws], [t.to(dev) for t in bs]


def dense_level(x, ws, bs, conv=None):
    """A level's dense block as ``PWCDCNet._dense`` runs it without
    autograd: one buffer, the input at its tail, each conv into the slot
    before its input; with ``conv`` (a plain function) the block as it ran
    before, each output joined by ``torch.cat``."""
    if conv is not None:
        for wt, b in zip(ws, bs):
            x = torch.cat([conv(x, wt, b), x], 1)
        return x
    n, od, h, w = x.shape
    buf = x.new_empty((n, sum(DENSE) + od, h, w))
    buf[:, sum(DENSE):].copy_(x)
    start = sum(DENSE)
    for wt, b in zip(ws, bs):
        DC.dense_conv_into(buf, start, wt, b)
        start -= wt.shape[0]
    return buf


def cudnn_dense_benchmarked(x, wt, b):
    """K10's yardstick: cuDNN's float32 leaky_relu(conv2d) with
    cudnn.benchmark on (its choice among algorithms, made on the first call
    of a shape)."""
    torch.backends.cudnn.benchmark = True
    try:
        return DC.dense_conv_plain(x, wt, b)
    finally:
        torch.backends.cudnn.benchmark = False


def _compare_k10(label, buf, again, ws, bs) -> float:
    """Each conv of a level against float64 on the input it read: its error
    over the float64 sum of |x||w| + |b| at most DENSE_TOL; the level run
    twice bit for bit.  Returns the largest error over the sum."""
    worst, start = 0.0, sum(DENSE)
    for wt, b in zip(ws, bs):
        cout, cin = wt.shape[:2]
        xd, wd, bd = buf[:, start:start + cin].double(), wt.double(), b.double()
        want = F.leaky_relu(F.conv2d(xd, wd, bd, padding=1), DC.SLOPE)
        scale = F.conv2d(xd.abs(), wd.abs(), bd.abs(), padding=1)
        worst = max(worst, ((buf[:, start - cout:start].double() - want).abs()
                            / scale).max().item())
        del xd, want, scale
        start -= cout
    same = torch.equal(buf, again)
    print(f"[kernels] dense_conv K10 {label}: error over sum |x||w| + |b| "
          f"{worst:.3e} against float64 (tolerance {DENSE_TOL:.0e}); two "
          f"runs {'bit-equal' if same else 'DIFFER'}")
    if not (worst <= DENSE_TOL and same):
        raise AssertionError(f"dense_conv {label}: failed its check")
    return worst


def phase_dense_conv(dev: torch.device, card: str) -> dict:
    """K10's launches in a DAIN forward, then K10 at the cells' levels
    against float64 and timed beside its bound, the plain version and
    cuDNN autotuned.  Returns K10's row of the kernels line."""
    model = make_model().to(dev).eval()
    g = torch.Generator().manual_seed(20)
    i0, i2 = make_frames(g)
    kernels.reset_launches()
    with torch.inference_mode():
        model(i0.to(dev), i2.to(dev))
    torch.cuda.synchronize()
    print(f"[dense] a DAIN forward at {W}x{H}: launches "
          f"{dict(kernels.LAUNCHES)}")
    _check_launches("eval_forward", dict(kernels.LAUNCHES))
    del model

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row, slower = None, []
    for cell, n, lvl, (h, w) in DENSE_SHAPES:
        x, ws, bs = _dense_inputs(n, h, w, OD[lvl], seed=lvl)
        label = f"{cell} level {lvl} ({n},{OD[lvl]},{h},{w})"
        with torch.inference_mode():
            buf, again = dense_level(x, ws, bs), dense_level(x, ws, bs)
            err = _compare_k10(label, buf, again, ws, bs)
            del buf, again
            k10 = statistics.median(cuda_times_ms(
                lambda: dense_level(x, ws, bs), warmup=3, iters=20, inner=5))
            plain = statistics.median(cuda_times_ms(
                lambda: dense_level(x, ws, bs, DC.dense_conv_plain),
                warmup=3, iters=20, inner=5))
            tuned = statistics.median(cuda_times_ms(
                lambda: dense_level(x, ws, bs, cudnn_dense_benchmarked),
                warmup=3, iters=20, inner=5))
        work = [conv_work(n, wt.shape[1], wt.shape[0], h, w) for wt in ws]
        bound = sum(max(nb / HBM_BYTES_S, ops / F32_FLOP_S)
                    for nb, ops in work) * 1e3
        plans = [DC.plan(n, h, w, wt.shape[1], wt.shape[0], sms) for wt in ws]
        print(f"[times] K10 {label} (dense_conv, five convs, tile rows and "
              f"split {plans}): per level {k10:.4f} ms with the wrapper (CUDA "
              f"events, median of 20 runs of 5), plain (cuDNN, "
              f"cudnn.benchmark off, and torch.cat) {plain:.4f} ms, cuDNN "
              f"autotuned {tuned:.4f} ms; bound {bound:.4f} ms by "
              f"operations: {bound / k10:.1%} of it, on {card}")
        if k10 >= min(plain, tuned):
            slower.append(label)
        case = {"case": f"K10 {label}", "max_abs_err": err, "call_ms": k10,
                "plain_ms": plain, "library_ms": tuned, "bound_ms": bound,
                "bound_by": "operations"}
        if row is None:
            row = {"name": "dense_conv", "route": "cuda",
                   "source": "vfidkr_torch/csrc/dense_conv.cu",
                   "replaces": "none: cuDNN's conv, LeakyReLU and torch.cat "
                               "(vfidkr_tpu/models/pwcnet.py:71-79 is XLA)",
                   **case, "other_cases": []}
        else:
            row["other_cases"].append(case)
        del x, ws, bs
    print(f"[dense] levels where K10 is not the fastest: {slower or 'none'}")
    torch.cuda.synchronize()
    return row


def main() -> None:
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    # the paths first, checked and timed before any kernel case or profiler
    # session: after torch.profiler, host-bound timings read slower
    eval_launches = phase_slice(dev)
    model, i0, i2, slowmo_launches = phase_slowmo(dev)
    slowmo_ms = phase_slowmo_times(model, i0, i2)
    del model, i0, i2
    train_model, opt, batch, train_launches = phase_train(dev)
    phase_train_vs_cpu(dev)
    step_ms = phase_train_times(train_model, opt, batch)
    smt_model, smt_opt, smt_batch, smt_launches = phase_slowmo_train(dev)
    phase_slowmo_train_vs_cpu(dev)
    smt_ms = phase_train_times(smt_model, smt_opt, smt_batch,
                               f"DAINSlowMotion({TRAIN_T})")
    print(f"[time] the float32 paths checked and timed: "
          f"{time.perf_counter() - t0:.1f} s")
    eval_bf16, i0, i2, eval_bf16_launches = phase_eval_bf16(dev)
    slowmo_bf16, _, _, slowmo_bf16_launches = phase_slowmo_bf16(dev)
    mb_launches = phase_middlebury(dev)
    print(f"[time] the bf16 paths checked and timed: "
          f"{time.perf_counter() - t0:.1f} s")
    video_launches = phase_video(dev)
    print(f"[time] the video phase: {time.perf_counter() - t0:.1f} s")
    card = card_label()
    phase_native_augment(card)
    phase_train_from_disk(dev, step_ms, card)
    phase_depth(dev)
    print(f"[time] the drivers' phases checked and timed: "
          f"{time.perf_counter() - t0:.1f} s")
    parallel_launches = {"spatial_ops": phase_spatial_ops(dev),
                         "spatial_video": phase_spatial_video(dev),
                         "data_parallel": phase_data_parallel(dev)}
    print(f"[time] the parallel phases checked and timed: "
          f"{time.perf_counter() - t0:.1f} s")
    dormant_launches = {"dormant_ops": phase_dormant_ops(dev, card),
                        "vestigial_eval": phase_vestigial(dev, card)}
    phase_png_depths(dev, card)
    sepconv_launches, k9_row = phase_sepconv(dev, card)
    dormant_launches["sepconv_video"] = sepconv_launches
    k10_row = phase_dense_conv(dev, card)
    print(f"[time] the dormant ops, vestigial, PNG, SepConv and dense_conv "
          f"phases "
          f"checked and timed: {time.perf_counter() - t0:.1f} s")
    cases = phase_kernels(dev)
    times = phase_call_times(cases)
    phase_bf16_stages(dev, eval_bf16, slowmo_bf16, i0, i2)
    phase_slowmo_profile(dev, slowmo_ms)
    phase_train_profile(train_model, opt, batch, step_ms)
    phase_slowmo_train_profile(smt_model, smt_opt, smt_batch, smt_ms)
    phase_bf16_profile(eval_bf16, slowmo_bf16, i0, i2)
    phase_device_times(cases, times)
    phase_trace(dev, card)
    done = {key: {"kernel": c["kernel"], "max_abs_err": c["err"], **times[key],
                  **({"direct_tiles": c["direct_tiles"]}
                     if "direct_tiles" in c else {})}
            for key, c in cases.items()}
    per_path = {"eval_forward": eval_launches, "train_step": train_launches,
                "slowmo_forward": slowmo_launches,
                "eval_forward_bf16": eval_bf16_launches,
                "slowmo_forward_bf16": slowmo_bf16_launches,
                "middlebury_bf16": mb_launches,
                "slowmo_train_step": smt_launches, **video_launches,
                **parallel_launches, **dormant_launches}
    print(f"[launches] {per_path}")
    rows = []
    for name, (src, rep) in KERNELS.items():
        main_case = ROW_CASE[name]
        fields = lambda key: {k: v for k, v in done[key].items()
                              if k != "kernel"}
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(n[name] for n in per_path.values()),
            "launches_per_path": {p: n[name] for p, n in per_path.items()},
            "case": main_case, **fields(main_case),
            "other_cases": [{"case": key, **fields(key)}
                            for key, c in done.items()
                            if c["kernel"] == name and key != main_case]})
    for row in (k9_row, k10_row):
        name = row["name"]
        row["launches"] = sum(n[name] for n in per_path.values())
        row["launches_per_path"] = {p: n[name] for p, n in per_path.items()}
        rows.append(row)
    print(f"[time] chip_smoke.py took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
