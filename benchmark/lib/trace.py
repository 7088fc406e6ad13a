"""Reading a ``torch.profiler`` trace of a run's traced units into the
numbers the per-layer readers take.

The run records its own spans: ``bench/window`` around the traced units
(host clock, from the first unit's start to the synchronise after the
last), ``bench/unit`` around each pair or step, and the stage ranges that
the readers ask for (``RANGES``), opened by a forward pre-hook on one
module and closed by a forward hook on another (``StageRanges``), and
``bench/opt`` around the optimizer's step.  Each device operation (kernel,
copy, set) is tied to the host call that launched it by the profiler's
correlation id, so a span's device time is the device time of what was
launched inside it, on any thread (autograd launches the backward from a
thread of its own).

The device's idle share is taken over the whole traced window: 1 - (the
union of the device operations' intervals inside the window) / (the
window).  The host's gaps before the first operation and after the last
count as idle.
"""

from __future__ import annotations

import collections
import dataclasses

NAME_CHARS = 160        # a breakdown entry's name, cut to this length
WINDOW, UNIT, OPT, FORWARD = "bench/window", "bench/unit", "bench/opt", \
    "bench/forward"


@dataclasses.dataclass
class DeviceOp:
    start: int          # ns, the profiler's clock
    end: int
    name: str
    launch: int | None  # ns: when the host launched it, if known


@dataclasses.dataclass
class HostOp:
    start: int
    end: int
    name: str
    thread: int


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` (start, end) clipped to [lo,
    hi]."""
    busy, run_s, run_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if run_e is None or s > run_e:
            if run_e is not None:
                busy += run_e - run_s
            run_s, run_e = s, e
        else:
            run_e = max(run_e, e)
    if run_e is not None:
        busy += run_e - run_s
    return busy


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle gaps (start, end) of [lo, hi] between the merged
    ``intervals``, the leading and trailing ones included."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


@dataclasses.dataclass
class Trace:
    """One traced section: ``units`` pairs or steps inside ``window``."""
    units: int
    window: tuple
    ops: list
    host: list
    main_thread: int | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    # -- spans ---------------------------------------------------------
    def ranges(self, name: str) -> list:
        return [(h.start, h.end) for h in self.host if h.name == name]

    def linked_share(self) -> float:
        """Share of the window's device operations whose launch is known."""
        inside = [o for o in self.ops if self._in_window(o)]
        return (sum(o.launch is not None for o in inside) / len(inside)
                if inside else 0.0)

    def _in_window(self, op) -> bool:
        return op.end > self.window[0] and op.start < self.window[1]

    def launched_in(self, spans) -> list:
        """The device operations launched inside any of ``spans``."""
        spans = sorted(spans)
        out = []
        for o in self.ops:
            if o.launch is None:
                continue
            for s, e in spans:
                if s <= o.launch <= e:
                    out.append(o)
                    break
        return out

    def device_ns(self, ops) -> int:
        return sum(o.end - o.start for o in ops)

    def per_unit_ms(self, ns) -> float | None:
        if ns is None or self.units <= 0:
            return None
        return ns / 1e6 / self.units

    def range_device_ms(self, *names) -> float | None:
        """Device ms a unit launched inside the ranges ``names``; None where
        a range was never opened or launches are not linked."""
        spans = [r for n in names for r in self.ranges(n)]
        if not spans or self.linked_share() < 0.9:
            return None
        return self.per_unit_ms(self.device_ns(self.launched_in(spans)))

    def named_device_ms(self, *substrings) -> float | None:
        """Device ms a unit of the operations whose name holds any of
        ``substrings``; None where there is none."""
        ops = [o for o in self.ops if self._in_window(o)
               and any(s in o.name for s in substrings)]
        return self.per_unit_ms(self.device_ns(ops)) if ops else None

    # -- the device ----------------------------------------------------
    def busy_ns(self) -> int:
        return union_ns([(o.start, o.end) for o in self.ops], *self.window)

    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def idle_share(self) -> float | None:
        if not self.ops or self.window_ns() <= 0:
            return None
        return 1.0 - self.busy_ns() / self.window_ns()

    def top_ops(self, k: int = 10) -> list:
        tot = collections.Counter()
        for o in self.ops:
            if self._in_window(o):
                tot[o.name] += o.end - o.start
        return [[n[:NAME_CHARS], ns / 1e9] for n, ns in tot.most_common(k)]

    def top_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps, each named by the innermost host
        operation of the main thread running at its middle."""
        found = sorted(gaps([(o.start, o.end) for o in self.ops],
                            *self.window), key=lambda g: g[0] - g[1])[:k]
        host = [h for h in self.host if self.main_thread is None
                or h.thread == self.main_thread]
        out = []
        for s, e in found:
            mid = (s + e) // 2
            cover = [h for h in host if h.start <= mid <= h.end
                     and h.name != WINDOW]
            name = (max(cover, key=lambda h: h.start).name if cover
                    else "no host operation")
            out.append([name[:NAME_CHARS], (e - s) / 1e9])
        return out


_RUNTIME = ("cuda", "cu")


def from_profiler(prof, units: int) -> Trace:
    """The Trace of a ``torch.profiler.profile`` session that holds one
    ``bench/window`` range."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches, ops, host = {}, [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            h = HostOp(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
            host.append(h)
            if e.name().startswith(_RUNTIME) and e.correlation_id():
                launches[e.correlation_id()] = h.start
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append(DeviceOp(e.start_ns(), e.end_ns(), e.name(),
                                launches.get(e.correlation_id())))
    windows = [h for h in host if h.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW} range, found {len(windows)}")
    w = windows[0]
    return Trace(units, (w.start, w.end), ops, host, w.thread)


class StageRanges:
    """``bench/<name>`` profiler ranges around calls into the model's
    layers: each of ``specs`` (name -> (module opening it, module closing
    it), dotted paths under ``model``, "" the model itself) opens its range
    in a forward pre-hook and closes it in a forward hook."""

    def __init__(self, model, specs: dict):
        import torch
        self._rf = torch.autograd.profiler.record_function
        self._open = collections.defaultdict(list)
        self._handles = []
        for name, (first, last) in specs.items():
            rng = f"bench/{name}"
            self._handles.append(model.get_submodule(first)
                                 .register_forward_pre_hook(
                                     lambda m, a, rng=rng: self.enter(rng)))
            self._handles.append(model.get_submodule(last)
                                 .register_forward_hook(
                                     lambda m, a, o, rng=rng: self.exit(rng)))

    def enter(self, rng: str) -> None:
        rf = self._rf(rng)
        rf.__enter__()
        self._open[rng].append(rf)

    def exit(self, rng: str) -> None:
        if self._open[rng]:
            self._open[rng].pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def optimizer_range(optimizer, ranges: StageRanges) -> list:
    """``bench/opt`` around each optimizer step; returns the hook handles."""
    return [optimizer.register_step_pre_hook(
                lambda o, a, k: ranges.enter(OPT)),
            optimizer.register_step_post_hook(
                lambda o, a, k: ranges.exit(OPT))]


def traced_units(model, specs: dict, unit, units: int, sync,
                 optimizer=None) -> Trace:
    """``units`` calls of ``unit`` under ``torch.profiler``, each in a
    ``bench/unit`` range and all in ``bench/window`` (closed after
    ``sync``), with the stage ranges ``specs`` and ``bench/forward`` on the
    model (and ``bench/opt`` on ``optimizer``'s steps).  A session that
    recorded no device operation is run again, up to three in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ranges = StageRanges(model, dict(specs, forward=("", "")))
    handles = optimizer_range(optimizer, ranges) if optimizer else []
    rf = torch.autograd.profiler.record_function
    try:
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with rf(WINDOW):
                    for _ in range(units):
                        with rf(UNIT):
                            unit()
                    sync()
            t = from_profiler(prof, units)
            if t.ops:
                break
        return t
    finally:
        ranges.remove()
        for h in handles:
            h.remove()

