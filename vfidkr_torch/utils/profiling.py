"""Tracing and timing helpers: counterpart of the ``trace`` and ``Timer`` of
``vfidkr_tpu/utils/profiling.py``.

``trace(log_dir)`` records a ``torch.profiler`` session (the CPU, and the
card's kernels where CUDA is available) and writes it to ``log_dir`` as a
Chrome trace, in the layout TensorBoard's profiler plugin reads; Perfetto
opens the file itself.
``Timer`` is a wall-clock section timer over an ``AverageMeter`` (the
reference's ``proc_timer``/``loop_timer``, ``demo_MiddleBury.py:251-333``);
it does not synchronise the card, so a section that launches CUDA work
times the launches unless it synchronises itself.  JAX's feedback-scan
timers (``device_time``, ``device_time_slope``) are a TPU workaround the
port leaves behind: time the card with CUDA events.
"""

from __future__ import annotations

import contextlib
import time

import torch

from vfidkr_torch.utils.meters import AverageMeter


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; on leaving, write
    ``<log_dir>/<host>_<pid>.<time>.pt.trace.json`` (TensorBoard's layout).
    Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class Timer:
    """Wall-clock section timer: each ``with timer:`` adds the section's
    seconds to ``timer.meter``."""

    def __init__(self):
        self.meter = AverageMeter()
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.meter.update(time.perf_counter() - self._t0)
        return False
