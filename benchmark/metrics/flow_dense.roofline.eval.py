"""K10 ``dense_conv``'s share of its roofline in the traced pairs, percent:
the bound of PWC-Net's 25 dense-block convs a decode (operations at 67
TFLOP/s or bytes at 3.35 TB/s, the larger, conv by conv;
``benchmark/lib/flow_dense.py``) times the decodes traced (K10's launches
over 25), over K10's device time by kernel name.  The decode's shape is the
running cell's (``--workload`` on ``benchmark/run.py``'s command line): its
frames after the driver's padding, both directions of its batch.  A program
without K10, a cell that ``BENCHMARK.json`` does not list under this metric,
or a launch count that is not whole decodes reads None."""

from pathlib import Path

LAYER = "flow"
UNIT = "%"
MOVES = "frames_per_s"


def read(t):
    from benchmark.lib.cell import benchmark_spec, resolve
    from benchmark.lib.flow_dense import (KERNEL, LAUNCHES, bound_s,
                                          cell_decode, running_cell)
    ops = [o for o in t.ops if KERNEL in o.name and t._in_window(o)]
    name = running_cell()
    if not ops or name is None or len(ops) % LAUNCHES:
        return None
    spec = benchmark_spec()
    (metric,) = [m for m in spec["per_layer"]
                 if m["name"] == Path(__file__).stem]
    if name not in metric.get("workloads", []):
        return None
    decodes = len(ops) // LAUNCHES
    return (100.0 * bound_s(*cell_decode(resolve(name, spec))) * decodes
            / (t.device_ns(ops) / 1e9))
