"""K14 ``adacof``'s share of its roofline in the traced pairs, percent: its
launches' bound (bytes at 3.35 TB/s or operations at 67 TFLOP/s, the
larger; ``benchmark/lib/adacof.py``) over their device time, by kernel
name.  The launches' shape is the cells' own: the traffic's frames after
the driver's padding, with the configuration's F^2 taps
(``adacof.cell_shape``), for the cells that ``BENCHMARK.json`` lists under
this metric (one shape among them).  A program without K14 reads None."""

from pathlib import Path

LAYER = "adacof sampling"
UNIT = "%"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.adacof import KERNEL, bound_s, cell_shape
    from benchmark.lib.cell import benchmark_spec, resolve
    ops = [o for o in t.ops if KERNEL in o.name and t._in_window(o)]
    if not ops:
        return None
    spec = benchmark_spec()
    (metric,) = [m for m in spec["per_layer"]
                 if m["name"] == Path(__file__).stem]
    shapes = {cell_shape(resolve(c, spec)) for c in metric["workloads"]}
    if len(shapes) != 1:
        return None
    (shape,) = shapes
    return 100.0 * bound_s(*shape) * len(ops) / (t.device_ns(ops) / 1e9)
