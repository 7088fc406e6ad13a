"""Launching the hand-written CUDA kernels, and counting their launches.

``LAUNCHES[name]`` is a plain integer that ``launch`` raises by one each time
it launches kernel ``name``, and nowhere else, so a run can show that its
main path went through the kernels.  ``reset_launches`` sets every count
to 0.
"""

from __future__ import annotations

import torch

from vfidkr_torch.kernels import build

KERNELS = ("filter_interpolate_fwd", "flow_project_scatter",
           "flow_project_finalize", "filter_interpolate_bwd",
           "flow_project_scatter_bwd")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
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
    LAUNCHES[name] += 1
