"""Tracing: the program's spans, and a ``torch.profiler`` session that
records them.

``span(name)`` marks a stage of the program as a ``torch.profiler`` range
(a host span on the profiler's clock; the card's work launched inside it is
tied to it by correlation id).  It records only while a profiler session
is recording, any session: the benchmark's traced runs, ``trace(log_dir)``,
or a caller's own ``torch.profiler.profile``.  Otherwise it returns one
shared object that does nothing, so a span costs one check.

A span may also name the backward of its stage.  ``with span(name) as s:
...; s.outputs(*tensors)``, where grad is enabled, marks every autograd
node that the body created and that ``tensors`` reach as ``<name>/backward``
(``backward_spans``): the node's range opens just before it runs and closes
just after, on the thread that runs it.  The hooks live on the graph's
nodes, so they go with the graph after the backward.

``trace(log_dir)`` records a ``torch.profiler`` session (the CPU, and the
card's kernels where CUDA is available) and writes it to ``log_dir`` as a
Chrome trace, in the layout TensorBoard's profiler plugin reads; Perfetto
opens the file itself.  JAX's timers (``Timer``, ``device_time``,
``device_time_slope``) are left behind: time the card with CUDA events or
read a trace.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

_sequence_nr = torch._C._autograd._get_sequence_nr


class _Off:
    """What ``span`` returns while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def outputs(self, *tensors) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "_range", "_seq_lo", "_outputs")

    def __init__(self, name: str):
        self.name = name
        self._range = record_function(name)
        self._outputs = ()

    def __enter__(self):
        self._range.__enter__()
        # the first sequence number of the nodes this stage creates
        self._seq_lo = _sequence_nr() if torch.is_grad_enabled() else None
        return self

    def outputs(self, *tensors) -> None:
        """The tensors the stage hands on: their graph, back to the span's
        start, is the stage's backward."""
        self._outputs = tensors

    def __exit__(self, *exc):
        try:
            if self._seq_lo is not None and self._outputs:
                backward_spans(self.name, self._outputs, self._seq_lo)
        finally:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A profiler range ``name`` around the ``with`` body while a profiler
    session records; else the shared no-op ``OFF``."""
    if torch.autograd._profiler_enabled():
        return _Span(name)
    return OFF


def _hook(node, label: str) -> None:
    opened = []

    def pre(grad_outputs):
        rng = record_function(label)
        rng.__enter__()
        opened.append(rng)

    def post(grad_inputs, grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


def backward_spans(name: str, outputs, seq_lo: int) -> None:
    """Open a ``<name>/backward`` range around each autograd node that
    ``outputs`` reach and whose sequence number is at least ``seq_lo`` (read
    with ``torch._C._autograd._get_sequence_nr()`` when the stage began:
    the nodes it created).  ``AccumulateGrad`` nodes, which belong to no
    stage, are left out."""
    label = f"{name}/backward"
    todo = [t.grad_fn for t in outputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if (type(node).__name__ == "AccumulateGrad"
                or node._sequence_nr() < seq_lo):
            continue
        _hook(node, label)
        todo.extend(n for n, _ in node.next_functions)


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
