"""One run of one cell: set-up, the measured window, the end-to-end or
per-layer metrics, the check, and the result line.

A workload file's ``cpus`` keeps the process on that many CPUs (the last
it may use) from before the CUDA context on: a cell whose pace the host
sets then does not move from core to core.

``setup_s`` runs from the process's start (the first line of
``benchmark/run.py``) to the window's start: importing, the CUDA context,
the kernels' build or load, the weights and traffic made from the seed, and
the warm-up pairs or the check's first training steps.  The window then
runs for ``seconds``; with ``trace`` a bounded number of its units run
under ``torch.profiler`` and the per-layer readers read them.  After the
window the program's state is freed and the reference runs for the check.
"""

from __future__ import annotations

import math
import os
import sys
import time

import torch

from benchmark.lib import check, work
from benchmark.lib.cell import lane_of, load_reader

GIB = 1024 ** 3


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value at or above
    95 % of ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def pin_cpus(n: int) -> list:
    """Keep this thread, and every thread it starts later, on the last
    ``n`` CPUs that it may use; returns them."""
    allowed = sorted(os.sched_getaffinity(0))
    cpus = allowed[-n:]
    os.sched_setaffinity(0, cpus)
    return cpus


def end_to_end(cell: dict, win: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from its window."""
    have = {"setup_s": setup_s, "peak_mem_gib": win["peak"] / GIB}
    if "produced" in win:
        have["frames_per_s"] = win["produced"] / win["elapsed"]
        have["pair_latency_p95_ms"] = p95(win["latencies"]) * 1000.0
    if "steps" in win:
        have["train_step_ms"] = win["elapsed"] / win["steps"] * 1000.0
    return {m["name"]: {"value": have[m["name"]], "unit": m["unit"]}
            for m in cell["end_to_end"]}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, err=sys.stderr) -> dict:
    """Run ``cell`` once; returns the result line's object."""
    from benchmark.lib.evalcell import EvalRun
    from benchmark.lib.traincell import TrainRun
    from benchmark.reference import nets

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_imported = time.perf_counter() - t_start
    device = torch.device(device)
    if device.type == "cuda" and cell["workload"].get("cpus"):
        print(f"on CPUs {pin_cpus(cell['workload']['cpus'])}", file=err)
    readers = ({m["name"]: load_reader(m["name"]) for m in cell["per_layer"]}
               if trace else {})
    run = (EvalRun if cell["workload"]["mode"] == "eval" else TrainRun)(
        cell, seed, device)
    run.readers = readers
    phases = [("imports", t_imported)]
    last = [time.perf_counter()]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        phases.append((phase, now - last[0]))
        last[0] = now

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        mark("CUDA context")
    run.setup(mark)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s!r} s: " + ", ".join(
        f"{phase} {seconds!r}" for phase, seconds in phases), file=err)
    win = run.window(seconds, trace)
    memory_peak = max(setup_peak, win["peak"])
    attempted = win.get("pairs", win.get("steps"))
    trace_obj = win["trace"]
    run.free()

    numbers = run.check(win)
    ok, table = check.verdict(numbers, cell["workload"]["limits"])

    result = {"correct": ok, "attempted": attempted, "failed": 0}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["entry"]["chips"], "memory_peak_bytes": memory_peak}
    if not trace:
        result["metrics"] = end_to_end(cell, win, setup_s)
    else:
        t = trace_obj
        t.extra.update(launches=win["launches"], lane=lane_of(cell),
                       flops=work.conv_flops_by_stage(run.flops_call(win), nets)
                       if t.ops else {})
        metrics = {}
        for m in cell["per_layer"]:
            value = readers[m["name"]].read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev.update(busy_s=t.busy_ns() / 1e9, window_s=t.window_ns() / 1e9)
        result["breakdown"] = {"device_ops": t.top_ops(10),
                               "idle_gaps": t.top_gaps(10)}
        per_kernel = kernel_shares(t)
        for name, share in per_kernel.items():
            print(f"kernel {name} roofline share {share!r} %", file=err)
    result["device"] = dev
    for name, value in numbers.items():
        if name not in table:
            print(f"info {name} {value!r} (not limited)", file=err)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=err)
    print(f"correct {str(ok).lower()}", file=err)
    result["check"] = table
    return result


def _kernel_ops(t, name: str) -> list:
    return [o for o in t.ops if f"{name}_kernel" in o.name and t._in_window(o)]


def kernel_shares(t) -> dict:
    """Each hand-written kernel's share of its roofline in the traced
    units (percent), where every launch was traced."""
    out = {}
    for name, (count, bound) in (t.extra.get("launches") or {}).items():
        ops = _kernel_ops(t, name)
        if ops and len(ops) == count * t.units:
            out[name] = 100.0 * bound * t.units / (t.device_ns(ops) / 1e9)
    return out


def roofline_share(t) -> float | None:
    """Every hand-written kernel launch's bound over their device time, in
    percent; None unless every launch of the traced units was traced."""
    bound, dev_ns = 0.0, 0
    for name, (count, b) in (t.extra.get("launches") or {}).items():
        ops = _kernel_ops(t, name)
        if len(ops) != count * t.units:
            return None
        bound += b * t.units
        dev_ns += t.device_ns(ops)
    return 100.0 * bound / (dev_ns / 1e9) if dev_ns else None


def mfu(t) -> float | None:
    """The least time of the traced units' FLOPs at the peaks of their
    precisions over the traced window's time, in percent."""
    flops = t.extra.get("flops")
    if not flops or t.window_ns() <= 0:
        return None
    least = work.least_seconds(flops, t.extra["lane"]) * t.units
    return 100.0 * least / (t.window_ns() / 1e9)
