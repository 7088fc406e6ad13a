"""K9 ``sepconv_pair``'s share of its roofline in the traced pairs, percent:
its launches' bound (operations at 67 TFLOP/s or bytes at 3.35 TB/s, the
larger; ``benchmark/lib/local_conv.py``) over their device time.  The
launches' shape is the cells' own: the traffic's frames after the driver's
padding, with the configuration's taps (``local_conv.cell_shape``), for the
cells that ``BENCHMARK.json`` lists under this metric (one shape among
them).  A program without K9 reads None."""

from pathlib import Path

LAYER = "local conv"
UNIT = "%"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.cell import benchmark_spec, resolve
    from benchmark.lib.local_conv import KERNEL, bound_s, cell_shape
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
