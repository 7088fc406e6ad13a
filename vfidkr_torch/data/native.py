"""The trainer's triplet augment on the host, in C++ with OpenMP.

Counterpart of ``vfidkr_tpu/data/native.py``.  The source is the port's own
(``vfidkr_torch/csrc/host/augment.cpp``); at first use it is compiled with
``g++ -O3 -fPIC -fopenmp -c`` (``$CXX`` where set) and linked ``-shared``
against the libgomp that PyTorch has already loaded into the process and
no other, so the process holds one OpenMP runtime (and the link needs no
libgomp of the compiler's own: a relocated compiler may lack
``libgomp.spec``), into ``build/vfidkr_torch/`` at the root of the checkout,
under a file name that carries a hash of the source, the flags and that
libgomp, and loaded with ``ctypes.CDLL`` (a call releases the GIL).  Where
the compiler is missing, no libgomp is mapped or the build fails it raises:
there is no fallback.
``vimeo90k.augment_triplet`` is the plain Python version the tests hold it
to.

The random draws stay in Python (``vimeo90k.draw_augment``, the reference's
order); the library does the data movement: the temporal swap, the crop, the
flips and ``u8 / 255.0f``, written as (B, 3, h, w) float32 CPU tensors (x0
the first frame, x1 the last, y the middle one), one call for each group of
equal-size frames.

Each call runs ``thread_count()`` OpenMP threads: ``OMP_NUM_THREADS`` where
set, else the CPUs this process may run on (``os.sched_getaffinity``: in a
container the host's count oversubscribes), at most ``MAX_THREADS``.  With
an H100 on an 8-CPU host the trainer's ms/step from disk is the same at 1,
2, 4 and 8 threads, while the augment alone is fastest at 4 for a batch of
12 (``PERF.md``): more threads only contend with the decode workers and
the launching thread.  libgomp is not fork-safe: the library is called only
from the process that loaded it (the trainer's decode workers, forked
children, only decode).
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
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from vfidkr_torch.kernels.build import BUILD_DIR

__all__ = ["augment_triplets", "build", "library_path", "load_library",
           "openmp_runtimes", "reset_calls", "thread_count"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "augment.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-std=c++17", "-Wall"]
MAX_THREADS = 4

_P, _I = ctypes.c_void_p, ctypes.c_int32
# frames, n, h, w, crop_h, crop_w, aug, slot, x0, x1, y, threads
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I]

_LIB = None
_PID = None
_LOAD_LOCK = threading.Lock()
# the library calls made (one a group of equal-size frames), so a run can
# show that its batches went through the augment; reset_calls sets it to 0
CALLS = 0
_CALLS_LOCK = threading.Lock()


def reset_calls() -> None:
    global CALLS
    with _CALLS_LOCK:
        CALLS = 0


def find_cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found (set $CXX or PATH): the "
            f"vfidkr_torch host augment cannot be built")
    return path


def link_args() -> list:
    """The link's OpenMP runtime: the libgomp that PyTorch mapped into this
    process."""
    gomp = [p for p in openmp_runtimes() if "libgomp" in Path(p).name]
    if not gomp:
        raise RuntimeError(
            "no libgomp is mapped into this process (PyTorch loads one on "
            "Linux): the vfidkr_torch host augment links against PyTorch's "
            "OpenMP runtime and no other")
    return gomp[:1]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + link_args()).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvfidkr_augment-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the augment unless the library for this source exists."""
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a temporary name and renamed: a concurrent or interrupted
    # build never leaves a partial library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        obj, so = Path(tmp) / "augment.o", Path(tmp) / lib.name
        for cmd in ([cxx, *CXX_FLAGS, "-c", "-o", str(obj), str(SOURCE)],
                    [cxx, "-shared", "-o", str(so), str(obj), *link_args()]):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {SOURCE.name} "
                                   f"({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
        os.replace(so, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the augment library."""
    global _LIB, _PID
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.vfidkr_augment_triplets.argtypes = _ARGTYPES
            lib.vfidkr_augment_triplets.restype = None
            _LIB, _PID = lib, os.getpid()
    if os.getpid() != _PID:
        raise RuntimeError(
            f"the host augment was loaded by process {_PID} and is called "
            f"in its forked child {os.getpid()}: libgomp is not fork-safe")
    return _LIB


def thread_count() -> int:
    """``OMP_NUM_THREADS`` where set (its first level), else the CPUs this
    process may run on, at most ``MAX_THREADS``."""
    env = os.environ.get("OMP_NUM_THREADS", "").split(",")[0].strip()
    if env.isdigit() and int(env) > 0:
        return int(env)
    try:
        cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cpus = os.cpu_count() or 1
    return min(cpus, MAX_THREADS)


def augment_triplets(triplets: Sequence[Sequence[np.ndarray]],
                     records: Sequence[Sequence[int]],
                     crop_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """(im1, im2, im3) uint8 (h, w, 3) frames of each sample, and its record
    (swap, oy, ox, fliplr, flipud) -> dict(x0, x1, y) of (B, 3, ch, cw)
    float32 CPU tensors.  The samples' frames may differ in size: one call
    covers each group of equal-size frames.  A frame smaller than
    ``crop_hw`` is cropped to its own size along that axis, as a numpy
    slice is; the samples must then agree on the size."""
    global CALLS
    lib = load_library()
    n = len(triplets)
    if len(records) != n:
        raise ValueError(f"{n} triplets but {len(records)} records")
    groups: Dict[Tuple[int, int], list] = {}
    for i, trip in enumerate(triplets):
        groups.setdefault(tuple(trip[0].shape[:2]), []).append(i)
    crops = {(min(h, crop_hw[0]), min(w, crop_hw[1])) for h, w in groups}
    if len(crops) > 1:
        raise ValueError(f"frames of {sorted(groups)} crop to different "
                         f"sizes {sorted(crops)}")
    ch, cw = crops.pop() if crops else crop_hw
    out = {k: torch.empty(n, 3, ch, cw) for k in ("x0", "x1", "y")}
    for (h, w), idx in groups.items():
        frames = [np.ascontiguousarray(f, np.uint8)
                  for i in idx for f in triplets[i]]
        if any(f.shape != (h, w, 3) for f in frames):
            raise ValueError(f"a triplet's frames differ from ({h}, {w}, 3)")
        aug = np.ascontiguousarray([records[i] for i in idx], np.int32)
        if aug.shape != (len(idx), 5):
            raise ValueError(f"records must be (swap, oy, ox, fliplr, "
                             f"flipud), got shape {aug.shape}")
        oy, ox = aug[:, 1], aug[:, 2]
        if (oy < 0).any() or (ox < 0).any() or (oy + ch > h).any() \
                or (ox + cw > w).any():
            raise ValueError(f"a crop of {(ch, cw)} at "
                             f"{aug[:, 1:3].tolist()} leaves the ({h}, {w}) "
                             f"frames")
        slot = np.asarray(idx, np.int32)
        ptrs = (ctypes.c_void_p * len(frames))(*(f.ctypes.data
                                                 for f in frames))
        lib.vfidkr_augment_triplets(
            ptrs, len(idx), h, w, ch, cw, aug.ctypes.data, slot.ctypes.data,
            out["x0"].data_ptr(), out["x1"].data_ptr(), out["y"].data_ptr(),
            thread_count())
        with _CALLS_LOCK:
            CALLS += 1
    return out


def openmp_runtimes() -> list:
    """The distinct OpenMP runtime files mapped into this process (one where
    the library shares PyTorch's libgomp)."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "libgomp" in line or "libiomp" in line})
