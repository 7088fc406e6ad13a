"""K12 ``softmax_splat``'s share of its roofline in the traced pairs,
percent: the bound of a pair's three launches (bytes at 3.35 TB/s or
operations at 67 TFLOP/s, the larger, level by level;
``benchmark/lib/softsplat.py``) times the pairs traced (K12's kernels over
6), over the device time of K12's entry point: its two kernels by name (the
scatter and the division) and the memsets launched inside the program's
``vfidkr/softsplat/splat`` spans (the entry point zeroes its scratch sum
before the scatter; nothing else there sets memory).  The pair's shape is
the cells' own: the traffic's frames after the driver's padding, both
directions, the configuration's channels (``softsplat.cell_pair``), for the
cells that ``BENCHMARK.json`` lists under this metric (one shape among
them).  A program without K12 reads None, as does a trace whose launches
are not linked to their spans."""

from pathlib import Path

LAYER = "softsplat splat"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS_A_LAUNCH = 2        # the scatter and the division
SPAN = "vfidkr/softsplat/splat"
SETS = "Memset"


def read(t):
    from benchmark.lib.cell import benchmark_spec, resolve
    from benchmark.lib.softsplat import KERNEL, cell_pair, levels, \
        pair_bound_s
    from benchmark.lib.spans import launched
    ops = [o for o in t.ops if KERNEL in o.name and t._in_window(o)]
    if not ops:
        return None
    in_span = launched(t, t.ranges(SPAN))
    if in_span is None:
        return None
    sets = [o for o in in_span if o.name.startswith(SETS)
            and t._in_window(o)]
    spec = benchmark_spec()
    (metric,) = [m for m in spec["per_layer"]
                 if m["name"] == Path(__file__).stem]
    shapes = {cell_pair(resolve(c, spec)) for c in metric["workloads"]}
    if len(shapes) != 1:
        return None
    (shape,) = shapes
    per_pair = KERNELS_A_LAUNCH * len(levels(*shape))
    if len(ops) % per_pair:
        return None
    pairs = len(ops) // per_pair
    return 100.0 * pair_bound_s(*shape) * pairs / (
        t.device_ns(ops + sets) / 1e9)
