"""Run one cell of the benchmark of vfidkr_torch once.

  python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
workload file and per-layer readers are found by name from
``BENCHMARK.json`` (see ``benchmark/lib/cell.py``).  The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s`` of the traced units, and ``breakdown``), and
last ``check``: each number compared beside its limit, also the last lines
of standard error.

It runs on the card: without CUDA, or with fewer cards than the cell asks
for, it exits 2 and prints no result.  Where a module of JAX or of the JAX
package (``jax``, ``jaxlib``, ``flax``, ``vfidkr_tpu``) is loaded once the
window has closed, it names it on standard error, exits 3 and prints no
result.  The kernels build into ``build/vfidkr_torch/`` of the checkout on
its first run there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = ("jax", "jaxlib", "flax", "vfidkr_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.lib.cell import resolve
    from benchmark.lib.harness import run_cell

    cell = resolve(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}; no "
              f"result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
