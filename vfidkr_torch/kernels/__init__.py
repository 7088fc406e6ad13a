"""Launching the hand-written CUDA kernels, and counting their launches.

``launch`` is the one caller of the kernel library (``kernels.build``): every
wrapper under ``vfidkr_torch/ops`` launches its kernel through it.

``LAUNCHES[name]`` is a plain integer that ``launch`` raises by one each time
it launches kernel ``name``, and nowhere else, so a run can show that its
main path went through the kernels.  It counts every kernel: the entry
points of K1-K7 in ``KERNELS`` and K8-K14 in ``UNRECORDED``.
``reset_launches`` sets every count to 0.  The counts are raised under a
lock: the shards of a row-sharded forward (``vfidkr_torch.parallel.spatial``)
launch from threads of their own.

Inside ``record_launches()`` each launch of a kernel in ``KERNELS`` also
keeps its name and arguments, so that a check can hold every launch of a run
to the kernel's plain version on the same inputs.  The launches of
``UNRECORDED`` are counted and not recorded: the benchmark turns every
record into a roofline bound (``benchmark/lib/work.kernel_work``), which has
no work count for K8-K14 and raises on them.

``sm_count`` gives a device's SM count, from which the wrappers of K10 and
K11 plan their tiles and splits.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from vfidkr_torch.kernels import build

KERNELS = ("filter_interpolate_fwd", "flow_project_scatter",
           "flow_project_finalize", "filter_interpolate_bwd",
           "flow_project_scatter_bwd", "filter_interpolate_ctx",
           "fused_resblocks", "depth_flow_project_bwd")
UNRECORDED = ("rectify_head", "sepconv_pair", "dense_conv", "flow_head",
              "softmax_splat", "correlation", "correlation_bwd", "adacof")
LAUNCHES = dict.fromkeys(KERNELS + UNRECORDED, 0)
_LOCK = threading.Lock()
_RECORDS: list | None = None
_ENTRY: dict = {}       # name -> _entry(name)
_SMS: dict = {}         # device index -> SM count


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def record_launches():
    """Yield a list that gains ``(name, args)`` for every launch of a kernel
    in ``KERNELS`` made inside the context, from any thread; the tensors are
    the launch's own (its outputs hold the kernel's results once their
    stream has run)."""
    global _RECORDS
    records: list = []
    with _LOCK:
        if _RECORDS is not None:
            raise RuntimeError("record_launches is already active")
        _RECORDS = records
    try:
        yield records
    finally:
        with _LOCK:
            _RECORDS = None


def check_inputs(name: str, *tensors: torch.Tensor,
                 dtype: torch.dtype = torch.float32,
                 memory_format: torch.memory_format = torch.contiguous_format
                 ) -> None:
    """Raise unless every tensor is a CUDA tensor of ``dtype``, contiguous
    in ``memory_format``."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous(memory_format=memory_format):
            raise ValueError(f"{name}: expected a contiguous tensor "
                             f"({memory_format})")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (the current one without an
    index)."""
    idx = device.index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _entry(name: str) -> tuple:
    """(kernel ``name``'s entry point, the positions of its pointer
    arguments in ``build.SIGNATURES``, whether its launches are recorded)."""
    argtypes = build.SIGNATURES[f"vfidkr_{name}"][:-1]      # the stream last
    ptrs = tuple(i for i, t in enumerate(argtypes) if t is ctypes.c_void_p)
    return (getattr(build.load_library(), f"vfidkr_{name}"), ptrs,
            name in KERNELS)


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream of its first tensor's
    device with ``args`` in its C signature's order (a tensor at a pointer
    position becomes its data pointer; ``None`` is a null pointer; an int
    stays as it is, a pointer into a tensor included); raise if the launch
    failed.  Only the pointer positions are inspected, and the device is
    switched only where it is not the current one: a PWC-Net forward
    launches K10 25 times and K11 5 times, and the host sets the pace of
    small frames."""
    entry = _ENTRY.get(name)
    if entry is None:
        entry = _ENTRY[name] = _entry(name)
    fn, ptrs, recorded = entry
    c_args, device = list(args), None
    for i in ptrs:
        a = c_args[i]
        if a is not None and not isinstance(a, int):
            c_args[i] = a.data_ptr()
            if device is None:
                device = a.get_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    if device == torch.cuda.current_device():
        err = fn(*c_args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _LOCK:
        LAUNCHES[name] += 1
        if recorded and _RECORDS is not None:
            _RECORDS.append((name, args))
