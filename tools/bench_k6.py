#!/usr/bin/env python3
"""What each part of K6's design buys, on one NVIDIA GPU.

    python3 tools/bench_k6.py [--other PATH ...]

Builds the committed source of K6 (``flow_project_scatter_bwd.cu``, both
kernels) and ablations of it, each its own library in ``build/ablations/``,
and times each kernel with torch.profiler (device time, median of 20
launches) at 2x256x448 and at the train steps' 6x256x448, on chip_smoke.py's
flow (``make_flow``: smooth up to +-24 px, 5 % of the pixels pushed out of
the frame; three draws at N = 6), on the paths' near-uniform (5.3, -3.1) px
move and on a converging flow (each cell read by several pixels):

* the kernels: ``flow_project_scatter_bwd`` (C = 2), ``depth_flow_project_bwd``
  without the depth gradient (as the slow-motion train step runs it) and
  with it;
* the variants: as committed; ``64-bit index division`` (each pixel's batch,
  row and column from its flat index by 64-bit divisions, as the
  one-dimensional kernel before had them); ``two divisions a cell`` (g / cnt
  as the plain version divides, not g times one reciprocal); ``4-row
  tiles`` and ``16-row tiles`` (blocks of 128 and 512 threads); ``no
  gathers`` (the floor: the flow read and the gradient written, no cell
  read);
* with ``--other PATH`` (repeatable): also the K6 source at PATH, named by
  its directory: an earlier commit's ``flow_project_scatter_bwd.cu``, such
  as the one-dimensional kernel (its entry points take what the committed
  ones take) or the design that staged each tile's cells in shared memory
  (they take a nullable direct-gather tile counter before the stream).

Every variant but ``no gathers`` is held to the plain versions (1e-5 x
max(1, max |plain|)): each computes the same function.  The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_geometry as geo  # noqa: E402
from bench_k7_k3 import device_us, library  # noqa: E402
from vfidkr_torch.kernels import build  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402

K6_SRC = build.CSRC_DIR / "flow_project_scatter_bwd.cu"

ABLATIONS = {
    "64-bit index division": [(
        """  const int x = blockIdx.x * TW + threadIdx.x;
  const int y = blockIdx.y * TH + threadIdx.y;
  const int b = blockIdx.z;
""", """  const long long hw64 = (long long)h * w;
  const long long flat = ((long long)blockIdx.z * h + blockIdx.y * TH + threadIdx.y)
                         * w + blockIdx.x * TW + threadIdx.x;
  const int b = (int)(flat / hw64);
  const int y = (int)((flat - b * hw64) / w);
  const int x = (int)(flat - b * hw64 - (long long)y * w);
""")],
    "two divisions a cell": [("""      const float rcp = 1.0f / fmaxf(v[2], 1e-30f);
      t[0] = v[0] * rcp;
      t[1] = v[1] * rcp;
""", """      const float den = fmaxf(v[2], 1e-30f);
      t[0] = v[0] / den;
      t[1] = v[1] / den;
""")],
    "4-row tiles": [("constexpr int TH = 8;", "constexpr int TH = 4;")],
    "16-row tiles": [("constexpr int TH = 8;", "constexpr int TH = 16;")],
    "no gathers": [("  for (int k = 0; k < 4; ++k) f.load(cells[k], v[k]);",
                    """  for (int k = 0; k < 4; ++k)
    for (int r = 0; r < R; ++r) v[k][r] = 1.0f + (cells[k] & 1);""")],
}
UNCHECKED = ("no gathers",)


def _entry(lib, name, counted):
    """The entry point ``name``; ``counted``: it takes a tile counter
    before the stream (the staged design)."""
    fn = getattr(lib, name)
    sig = build.SIGNATURES[name]
    fn.argtypes = sig[:-1] + [ctypes.c_void_p] + sig[-1:] if counted else sig
    return fn


def launch(lib, counted, kernel, ins):
    """One launch of ``kernel`` from ``lib`` on the inputs ``ins``."""
    stream = torch.cuda.current_stream().cuda_stream
    extra = (None,) if counted else ()
    if kernel == "flow_project_scatter_bwd":
        flow, g = ins["flow"], ins["g3"]
        gflow = torch.empty_like(flow)
        err = _entry(lib, "vfidkr_flow_project_scatter_bwd", counted)(
            flow.data_ptr(), g.data_ptr(), gflow.data_ptr(), *flow.shape[:1],
            *flow.shape[2:], *extra, stream)
        outs = (gflow,)
    else:
        need_depth = kernel.endswith("with gdepth")
        flow = ins["flow"]
        gflow = torch.empty_like(flow)
        gdepth = torch.empty_like(ins["depth"]) if need_depth else None
        err = _entry(lib, "vfidkr_depth_flow_project_bwd", counted)(
            *(ins[k].data_ptr() for k in ("flow", "depth", "g2", "cnt", "out")),
            gflow.data_ptr(), None if gdepth is None else gdepth.data_ptr(),
            flow.shape[0], *flow.shape[2:], *extra, stream)
        outs = (gflow,) if gdepth is None else (gflow, gdepth)
    if err:
        raise RuntimeError(f"{kernel}: launch failed with error {err}")
    return outs


def plain(kernel, ins):
    if kernel == "flow_project_scatter_bwd":
        f = ins["flow"].clone().requires_grad_()
        return torch.autograd.grad(FP.scatter4_plain(f), f, ins["g3"])
    need_depth = kernel.endswith("with gdepth")
    got = FP.depth_flow_project_bwd_plain(
        *(ins[k] for k in ("flow", "depth", "g2", "cnt", "out")),
        need_depth=need_depth)
    return got if need_depth else got[:1]


def inputs(g, rng, flow):
    n, _, h, w = flow.shape
    depth = torch.from_numpy(geo.depth_weight(rng, n, h, w)).to(flow.device)
    acc = FP.scatter4_plain(flow, depth)
    return {"flow": flow, "depth": depth,
            "g3": torch.randn(n, 3, h, w, generator=g).to(flow.device),
            "g2": torch.randn(n, 2, h, w, generator=g).to(flow.device),
            "cnt": acc[:, 2].contiguous(), "out": FP._count_average(acc)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, action="append", default=[],
                        help="another flow_project_scatter_bwd.cu to time "
                             "beside the committed one (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    variants = {"as committed": (K6_SRC, []), **{
        name: (K6_SRC, edits) for name, edits in ABLATIONS.items()}}
    counted = set()
    for path in args.other:
        variants[path.parent.name] = (path, [])
        if "int* direct_tiles" in path.read_text():
            counted.add(path.parent.name)
    libs = {name: library(src, name, edits)
            for name, (src, edits) in variants.items()}

    g = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(0)
    cases = {}
    for n in (cs.N, 3 * cs.N):
        flows = {
            "make_flow": torch.cat([cs.make_flow(g) for _ in range(n // cs.N)]),
            "near-uniform": torch.from_numpy(geo.smooth_flow(
                rng, n, cs.H, cs.W, 0.5, (5.3, -3.1))),
            "converging": torch.from_numpy(geo.converging_flow(
                n, cs.H, cs.W, 0.75))}
        for label, fl in flows.items():
            cases[f"N={n} {label}"] = inputs(g, rng, fl.to(dev))
    kernels = ("flow_project_scatter_bwd", "depth_flow_project_bwd",
               "depth_flow_project_bwd with gdepth")
    for kernel in kernels:
        for label, ins in cases.items():
            want = plain(kernel, ins)
            scale = max(1.0, *(w.abs().max().item() for w in want))
            for name, lib in libs.items():
                tiles = name in counted
                got = launch(lib, tiles, kernel, ins)
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                if name not in UNCHECKED and not err <= cs.ATOL * scale:
                    raise AssertionError(f"{kernel} {name} {label}: {err}")
                us = device_us(lambda: launch(lib, tiles, kernel, ins),
                               kernel.split(" ")[0] + "_kernel")
                print(f"{kernel:34s} {name:28s} {label:18s} {us:8.2f} us")


if __name__ == "__main__":
    main()
