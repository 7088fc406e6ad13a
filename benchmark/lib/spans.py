"""Reading the program's own spans from a ``Trace``.

The program records ``torch.profiler`` ranges at its stage boundaries
(``vfidkr_torch.utils.profiling.span``): ``vfidkr/forward`` and its stages,
PWC-Net's parts ``vfidkr/flow/*``, the driver's ``vfidkr/driver/*``, the
train step's phases ``vfidkr/train/*`` and, on the autograd thread, each
trained stage's ``vfidkr/<stage>/backward`` around every node of its
backward.  A program that records none of them reads None here.

A device operation counts in a span when the host launched it inside the
span (the correlation id; ``Trace.ops[i].launch``).  A backward span holds
one node's call; the engine adds the gradients the node hands on into its
consumers' inputs after the call, inside the same
``autograd::engine::evaluate_function`` event, so a backward span counts
the whole of that event.
"""

from __future__ import annotations

import bisect
import collections

from benchmark.lib.trace import gaps

FORWARD = "vfidkr/forward"
STEP = (FORWARD, "vfidkr/train/loss", "vfidkr/train/backward",
        "vfidkr/train/optimizer")
EVALUATE = "autograd::engine::evaluate_function: "
NOT_KERNELS = ("Memcpy", "Memset")


def merged(spans) -> list:
    """``spans`` (start, end) sorted and merged where they overlap."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def launched(t, spans) -> list | None:
    """The device operations launched inside any of ``spans``; None where
    there is no span or the launches are not linked.  ``Trace.launched_in``
    by bisection over the merged spans: a traced step holds thousands of
    backward spans."""
    if not spans or t.linked_share() < 0.9:
        return None
    m = merged(spans)
    starts = [s for s, _ in m]
    out = []
    for o in t.ops:
        if o.launch is None:
            continue
        i = bisect.bisect_right(starts, o.launch) - 1
        if i >= 0 and o.launch <= m[i][1]:
            out.append(o)
    return out


def _ms(t, ops) -> float | None:
    return None if ops is None else t.per_unit_ms(t.device_ns(ops))


def device_ms(t, *names) -> float | None:
    """Device ms a unit launched inside the spans ``names``."""
    return _ms(t, launched(t, [r for n in names for r in t.ranges(n)]))


def backward_spans(t, *names) -> list:
    """For each span named in ``names``: the engine's
    ``evaluate_function`` event on its thread that holds it, else the span
    itself."""
    evals = collections.defaultdict(list)
    for h in t.host:
        if h.name.startswith(EVALUATE):
            evals[h.thread].append((h.start, h.end))
    for lst in evals.values():
        lst.sort()
    out = []
    for h in t.host:
        if h.name not in names:
            continue
        lst = evals.get(h.thread, [])
        i = bisect.bisect_right(lst, (h.start, float("inf"))) - 1
        out.append(lst[i] if i >= 0 and lst[i][1] >= h.end
                   else (h.start, h.end))
    return out


def backward_ms(t, *names, forward=()) -> float | None:
    """Device ms a unit of the backward spans ``names`` (each widened to
    its node's evaluation), and of the spans ``forward`` as they are."""
    spans = backward_spans(t, *names)
    spans += [r for n in forward for r in t.ranges(n)]
    return _ms(t, launched(t, spans))


def kernels_launched(t, *names) -> float | None:
    """Device kernels (not copies or sets) a unit launched inside the
    spans ``names``."""
    ops = launched(t, [r for n in names for r in t.ranges(n)])
    if ops is None or t.units <= 0:
        return None
    return sum(not o.name.startswith(NOT_KERNELS) for o in ops) / t.units


def _overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split_ns(t, *names) -> tuple | None:
    """(idle ns of the window while the main thread is inside one of the
    spans ``names``, idle ns while it is not): the two add up to the
    window's idle time.  None where no such span was recorded."""
    spans = [(h.start, h.end) for h in t.host if h.name in names
             and (t.main_thread is None or h.thread == t.main_thread)]
    if not spans or not t.ops or t.window_ns() <= 0:
        return None
    idle = gaps([(o.start, o.end) for o in t.ops], *t.window)
    inside = _overlap_ns(idle, merged(spans))
    return inside, sum(e - s for s, e in idle) - inside


def idle_ms(t, *names, inside: bool) -> float | None:
    """Idle ms a unit of the window while the main thread is (``inside``)
    or is not inside one of the spans ``names``."""
    split = idle_split_ns(t, *names)
    return None if split is None else t.per_unit_ms(split[0 if inside
                                                          else 1])
