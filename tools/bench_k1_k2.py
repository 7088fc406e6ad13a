#!/usr/bin/env python3
"""What each part of K1's and K2's design buys, on one NVIDIA GPU.

    python3 tools/bench_k1_k2.py

Builds the committed sources of K2 (``flow_project_scatter.cu``) and K1
(``filter_interpolate.cu``) and ablations of them, each its own library in
``build/ablations/``, and times every one at chip_smoke.py's kernel inputs
with torch.profiler (device time, median of 20 launches), at 2x256x448 on
chip_smoke.py's flow (``make_flow``: smooth up to +-24 px, 5 % of the
pixels pushed out of the frame) and on the paths' near-uniform
(5.3, -3.1) px move:

* K2, plain and depth-weighted: as committed; ``every tile direct`` (each
  tile's adds straight to the sums, the scheme before the shared-memory
  box, on the same 2D grid); ``no vector flush`` (the box flushed by
  4-byte adds, as for a ragged W); ``no run sums`` (lanes that land in one
  cell each add to it, rather than their run's first lane once); ``box rows
  as wide as the box`` (no padding of a box row to whole rows of 32 banks).
  K2 also on a smooth converging flow (each cell the target of several
  neighbouring lanes, where the run sums act).
* K1 at C = 3: as committed; ``filter after the validity test`` (the 16
  filter planes asked for only once the flow says a pixel is valid: two
  round trips before the taps, as before); ``no taps`` (the image taps left out: what staging the image in
  shared memory could save at most).

Ablations compute wrong outputs; only the committed sources are held to
their plain versions.  The card's name and power limit come first.
"""

from __future__ import annotations

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
from vfidkr_torch.ops import filter_interpolation as FI  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402

K2_SRC = build.CSRC_DIR / "flow_project_scatter.cu"
K1_SRC = build.CSRC_DIR / "filter_interpolate.cu"

K2_ABLATIONS = {
    "every tile direct": [("  if ((long long)pitch * bh > BOX_MAX) {",
                           "  if (true) {")],
    "no vector flush": [("  if (w % 4 == 0 && reinterpret_cast<std::uintptr_t>"
                         "(acc) % 16 == 0)",
                         "  if (false)")],
    "no run sums": [("  const bool head = lane == 0 || prev_key != key;",
                     "  const bool head = true;")],
    "box rows as wide as the box": [("  const int pitch = (bw + 31) & ~31;",
                                     "  const int pitch = bw;")],
}
K1_ABLATIONS = {
    "filter after the validity test": [
        ("  for (int t = 0; t < 16; ++t) wgt[t] = __ldcs(filt + (16LL * b + t) * hw + p);",
         "  for (int t = 0; t < 16; ++t) wgt[t] = 0.0f;"),
        ("      wgt[dj * 4 + di] = wgt[dj * 4 + di] * wy * wx;",
         "      wgt[dj * 4 + di] = (valid ? __ldcs(filt + (16LL * b + dj * 4 + di) * hw + p)"
         " : 0.0f) * wy * wx;")],
    "no taps": [("acc += wgt[dj * 4 + di] * __ldg(plane + rows[dj] + cols[di]);",
                 "acc += wgt[dj * 4 + di];")],
}


def _entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = build.SIGNATURES[name]
    return fn


def k2(lib, flow, weight):
    fn = _entry(lib, "vfidkr_flow_project_scatter")
    n, _, h, w = flow.shape
    acc = torch.zeros(n, 3, h, w, device=flow.device)
    if fn(flow.data_ptr(), None if weight is None else weight.data_ptr(),
          acc.data_ptr(), n, h, w, None, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("flow_project_scatter: launch failed")
    return acc


def k1(lib, img, flow, filt):
    fn = _entry(lib, "vfidkr_filter_interpolate_fwd")
    out = torch.empty_like(img)
    if fn(img.data_ptr(), flow.data_ptr(), filt.data_ptr(), out.data_ptr(),
          *img.shape, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("filter_interpolate_fwd: launch failed")
    return out


def _check(name, got, want, exact_count=False):
    if exact_count and not torch.equal(got[:, 2], want[:, 2]):
        raise AssertionError(f"{name}: the count differs")
    err = ((got - want).abs() / want.abs().clamp(min=1)).max().item()
    if not err <= cs.ATOL:
        raise AssertionError(f"{name}: {err}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(0)
    flows = {"make_flow": cs.make_flow(g).to(dev),
             "near-uniform": torch.from_numpy(geo.smooth_flow(
                 np.random.RandomState(0), cs.N, cs.H, cs.W, 0.5,
                 (5.3, -3.1))).to(dev)}
    converging = torch.from_numpy(geo.converging_flow(cs.N, cs.H, cs.W,
                                                      0.75)).to(dev)
    image = torch.rand(cs.N, 3, cs.H, cs.W, generator=g).to(dev)
    filt = torch.randn(cs.N, 16, cs.H, cs.W, generator=g).to(dev)
    depth = torch.from_numpy(geo.depth_weight(np.random.RandomState(1), cs.N,
                                              cs.H, cs.W)).to(dev)
    for name, edits in {"as committed": [], **K2_ABLATIONS}.items():
        lib = library(K2_SRC, name, edits)
        for label, fl in {**flows, "converging": converging}.items():
            for weight in (None, depth):
                tag = f"{label}{'' if weight is None else ' weighted'}"
                if not edits:
                    _check(f"K2 {tag}", k2(lib, fl, weight),
                           FP.scatter4_plain(fl, weight), weight is None)
                us = device_us(lambda: k2(lib, fl, weight),
                               "flow_project_scatter_kernel")
                print(f"K2 {name:30s} {tag:22s} {us:8.2f} us")
    for name, edits in {"as committed": [], **K1_ABLATIONS}.items():
        lib = library(K1_SRC, name, edits)
        for label, fl in flows.items():
            if not edits:
                _check(f"K1 {label}", k1(lib, image, fl, filt),
                       FI.filter_interpolate_plain(image, fl, filt))
            us = device_us(lambda: k1(lib, image, fl, filt),
                           "filter_interpolate_fwd_kernel")
            print(f"K1 {name:30s} {label:22s} {us:8.2f} us")


if __name__ == "__main__":
    main()
