"""Launching the hand-written CUDA kernels, and counting their launches.

``LAUNCHES[name]`` is a plain integer that ``launch`` raises by one each time
it launches kernel ``name``, and nowhere else, so a run can show that its
main path went through the kernels.  ``reset_launches`` sets every count
to 0.  The counts are raised under a lock: the shards of a row-sharded
forward (``vfidkr_torch.parallel.spatial``) launch from threads of their own.
Inside ``record_launches()`` each launch also keeps its name and arguments,
so that a check can hold every launch of a run to the kernel's plain version
on the same inputs.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from vfidkr_torch.kernels import build

KERNELS = ("filter_interpolate_fwd", "flow_project_scatter",
           "flow_project_finalize", "filter_interpolate_bwd",
           "flow_project_scatter_bwd", "filter_interpolate_ctx",
           "fused_resblocks", "depth_flow_project_bwd")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_LOCK = threading.Lock()
_RECORDS: list | None = None


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def record_launches():
    """Yield a list that gains ``(name, args)`` for every launch made inside
    the context, from any thread; the tensors are the launch's own (its
    outputs hold the kernel's results once their stream has run)."""
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


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream with ``args`` (tensors
    become device pointers, ``None`` a null pointer, ints stay ints); raise
    if the launch failed."""
    fn = getattr(build.load_library(), f"vfidkr_{name}")
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        err = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _LOCK:
        LAUNCHES[name] += 1
        if _RECORDS is not None:
            _RECORDS.append((name, args))
