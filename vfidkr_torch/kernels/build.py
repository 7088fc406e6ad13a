"""Build the hand-written CUDA kernels of ``vfidkr_torch/csrc`` and load them.

Each source is compiled by its own ``nvcc``, all of them at once, and the
objects are linked into one shared library with a plain C interface, on first
use, into ``build/vfidkr_torch/`` at the root of the checkout.  The file
name carries a hash of the sources and the flags, so an edited source builds
anew and a built one is reused.  The library is loaded
with ``ctypes``; every entry point takes device pointers, int sizes and the
CUDA stream, and returns ``cudaGetLastError()`` after its launch.

No PyTorch headers are compiled (that takes minutes); nothing outside the
repository's sources is compiled or fetched.  Where ``nvcc`` is missing the
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vfidkr_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes: device pointers, int sizes, then the stream
# (``kernels.launch`` appends the stream to a wrapper's arguments).
SIGNATURES = {
    # image, flow, filt, out, n, c, h, w, row0, hg, stream; row0 and hg place
    # the block's rows in a row-sharded frame: the global row of local row 0
    # (negative on the first shard) and the frame's height (0 and h outside
    # a sharded frame)
    "vfidkr_filter_interpolate_fwd": [_P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _P],
    # image, flow, filt, g, gimage (or NULL), gflow, gfilt, n, c, h, w, stream
    "vfidkr_filter_interpolate_bwd": [_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _P],
    # image, flow, filt, out, n, c, h, w, row0, hg, direct-gather tile count
    # (or NULL), stream
    "vfidkr_filter_interpolate_ctx": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P, _P],
    # flow, weight (or NULL), acc, n, h, w, row0, hg, direct-add tile count
    # (or NULL), stream
    "vfidkr_flow_project_scatter": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # flow, g, gflow, n, h, w, stream
    "vfidkr_flow_project_scatter_bwd": [_P, _P, _P, _I, _I, _I, _P],
    # flow, depth, g, cnt, out, gflow, gdepth (or NULL), n, h, w, stream
    "vfidkr_depth_flow_project_bwd": [_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _P],
    # acc, out, n, h, w, first and end interior row of the up/down search,
    # carry_up and carry_down (N,3,W) (or NULL: no carry), stream
    "vfidkr_flow_project_finalize": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # x, w (one conv's packed taps), res (or NULL), out (NHWC), n, h, w, stream
    "vfidkr_fused_resblocks": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, w, b, out, n, c, h, w, stream (K8, ops/conv_head.py)
    "vfidkr_rectify_head": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # i0, v1, h1, i2, v2, h2, out, n, h, w, stream (K9,
    # ops/separable_conv.py)
    "vfidkr_sepconv_pair": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, x's batch stride, w, b, out, out's batch stride, n, cin, cout, h, w,
    # tile rows, split, stream (K10, ops/dense_conv.py)
    "vfidkr_dense_conv": [_P, _LL, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                          _I, _P],
}

_LIB = None
_LOAD_LOCK = threading.Lock()
BUILD_LOG = ""          # nvcc's output (ptxas register/spill report)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvfidkr_kernels-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        nvcc = str(cand) if cand.is_file() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin): the "
            "vfidkr_torch CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global BUILD_LOG
    lib = library_path()
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a temporary directory and rename the library: a concurrent
    # or interrupted build never leaves a partial library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        so = Path(tmp) / lib.name
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"linking failed ({proc.returncode}):\n"
                               f"{BUILD_LOG}")
        os.replace(so, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the kernel library; the shards of a
    row-sharded forward may ask for it from several threads at once."""
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB
