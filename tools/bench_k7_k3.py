#!/usr/bin/env python3
"""Where K7's and K3's device time goes, on one NVIDIA GPU.

    python3 tools/bench_k7_k3.py

Builds the committed sources of K7 (``filter_interpolate_ctx.cu``) and K3
(``flow_project_finalize.cu``) and ablations of them, each its own library
in ``build/ablations/``, and times every one at chip_smoke.py's kernel
inputs with torch.profiler (device time, median of 20 launches):

* K7 at 2x196x256x448 on chip_smoke.py's flow (``make_flow``, 5 % of the
  pixels pushed out of the frame) and on the paths' near-uniform
  (5.3, -3.1) px move: as committed; ``staging only`` (the box copies and
  the pipeline, no taps and no stores); ``a warp a row`` (each box row
  copied by one warp-wide cp.async, as before the copies became one list
  over the block's lanes).
* K3 at 2x256x448 on the scatter sums of ``make_flow`` and on a full-height
  edge band: as committed; ``no row scans`` and ``no column scans`` (the
  searches beyond the tile left out); ``floor`` (the filled cells only).

Ablations compute wrong outputs; only the committed sources are held to
their plain versions.  The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
import torch_geometry as geo  # noqa: E402
from vfidkr_torch.kernels import build  # noqa: E402
from vfidkr_torch.ops import filter_interpolation as FI  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402

OUT = ROOT / "build" / "ablations"
K7_SRC = build.CSRC_DIR / "filter_interpolate_ctx.cu"
K3_SRC = build.CSRC_DIR / "flow_project_finalize.cu"

K7_ABLATIONS = {
    "staging only": [
        ("acc += wgt[dj * 4 + di] * q[dj * bw + di];",
         "if (dj == 0 && di == 0) acc += wgt[0] * q[0];"),
        ("        dst[(ch0 + cc) * hw + p] = acc;\n",
         "        if (acc == 1234.5f) dst[(ch0 + cc) * hw + p] = acc;\n")],
    "a warp a row": [
        ("""    for (int e = threadIdx.x; e < nch * bh * vecs; e += THREADS) {
      const int rr = (int)((e * inv_vecs) >> 32);
      const int v = e - rr * vecs;
      const int cc = (int)((rr * inv_bh) >> 32);
      const int r = rr - cc * bh;
      cp_async<VEC>(buf + cc * area + r * bw + v * VEC,
                    img + (ch0 + cc) * hw + (long long)(by0 + r) * w + bx0 + v * VEC);
    }""", """    for (int rr = warp; rr < nch * bh; rr += TH) {
      const int cc = rr / bh;
      const int r = rr - cc * bh;
      for (int v = lane; v < vecs; v += TW)
        cp_async<VEC>(buf + cc * area + r * bw + v * VEC,
                      img + (ch0 + cc) * hw + (long long)(by0 + r) * w + bx0 + v * VEC);
    }""")],
}
K3_ABLATIONS = {
    "no row scans": [("  if (need_l || need_r)\n", "  if (false)\n")],
    "no column scans": [("  for (int k0 = 0;; k0 += SCAN_ROWS) {",
                         "  for (int k0 = 0; false; k0 += SCAN_ROWS) {")],
    "floor": [("  // along the row, beyond the tile, where a hole needs it",
               "  return;")],
}


def library(src: Path, name: str, edits) -> ctypes.CDLL:
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{src.stem}-{name.replace(' ', '_')}.cu"
    cu.write_text(text)
    so = cu.with_suffix(".so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    regs = [ln.split(":", 1)[1].strip() for ln in proc.stdout.splitlines()
            + proc.stderr.splitlines() if "registers" in ln]
    print(f"  {src.stem} {name}: {'; '.join(regs)}")
    return ctypes.CDLL(str(so))


def device_us(fn, kernel: str) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type.name == "CUDA" and kernel in e.name]
        if len(us) >= 10:
            return statistics.median(us)
    raise RuntimeError(f"{kernel}: the profiler recorded too few launches")


def k7(lib, img, flow, filt):
    fn = lib.vfidkr_filter_interpolate_ctx
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    out = torch.empty_like(img)
    if fn(img.data_ptr(), flow.data_ptr(), filt.data_ptr(), out.data_ptr(),
          *img.shape, None, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("filter_interpolate_ctx: launch failed")
    return out


def k3(lib, acc):
    fn = lib.vfidkr_flow_project_finalize
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    n, _, h, w = acc.shape
    out = torch.empty(n, 2, h, w, device=acc.device)
    if fn(acc.data_ptr(), out.data_ptr(), n, h, w,
          torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("flow_project_finalize: launch failed")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(0)
    flow = cs.make_flow(g).to(dev)
    filt = torch.randn(cs.N, 16, cs.H, cs.W, generator=g).to(dev)
    ctx = torch.rand(cs.N, cs.C_CTX, cs.H, cs.W, generator=g).to(dev)
    uniform = torch.from_numpy(geo.smooth_flow(
        np.random.RandomState(0), cs.N, cs.H, cs.W, 0.5, (5.3, -3.1))).to(dev)
    sums = {"make_flow": FP.scatter4(flow),
            "edge band": FP.scatter4(torch.from_numpy(
                geo.edge_band_flow(cs.N, cs.H, cs.W)).to(dev))}
    for name, edits in {"as committed": [], **K7_ABLATIONS}.items():
        lib = library(K7_SRC, name, edits)
        for label, fl in (("make_flow", flow), ("near-uniform", uniform)):
            if not edits:
                got = k7(lib, ctx, fl, filt)
                want = FI.filter_interpolate_plain(ctx, fl, filt)
                err = ((got - want).abs() / want.abs().clamp(min=1)).max()
                if not err.item() <= cs.ATOL:
                    raise AssertionError(f"K7 {label}: {err.item()}")
            us = device_us(lambda: k7(lib, ctx, fl, filt),
                           "filter_interpolate_ctx_kernel")
            print(f"K7 {name:15s} {label:13s} {us:8.2f} us")
    for name, edits in {"as committed": [], **K3_ABLATIONS}.items():
        lib = library(K3_SRC, name, edits)
        for label, acc in sums.items():
            if not edits and not torch.equal(k3(lib, acc),
                                              FP.finalize_plain(acc)):
                raise AssertionError(f"K3 {label}: not equal")
            us = device_us(lambda: k3(lib, acc),
                           "flow_project_finalize_kernel")
            print(f"K3 {name:15s} {label:13s} {us:8.2f} us")


if __name__ == "__main__":
    main()
