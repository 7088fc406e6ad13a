"""The readings that a cell's check limits are set from, on the card, at
the cell's own size, in one process.

  python benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
      [--control-seeds 21,22,23] [--control-children rectifyNet] \\
      [--faults] [--seconds 3]

For each of ``--seeds``: the program's numbers as a run computes them (set-
up, a window of ``--seconds``, the check), and, for each of
``--control-seeds``, the control's: the reference in the precision below
the configuration's (TF32 for float32 with TF32 off; float8 e4m3 for the
bf16 lane's modules) in the program's place.  With ``--faults`` (training
cells) also each fault's numbers: half of each batch left out (the mean
over the rest), and the first step's loss altered.  A state left unchanged
reads 1 by the change's measure and needs no run.  One JSON line a reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-children", default="",
                    help="put the control's precision in these children "
                    "only (comma-separated; evaluation cells)")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark.lib.cell import resolve
    from benchmark.lib.evalcell import EvalRun
    from benchmark.lib.traincell import TrainRun, compare

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = resolve(args.workload)
    Run = EvalRun if cell["workload"]["mode"] == "eval" else TrainRun
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    children = [c for c in args.control_children.split(",") if c]

    def say(kind, seed, numbers, t0):
        print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                          "numbers": numbers,
                          "s": round(time.perf_counter() - t0, 2)}),
              flush=True)

    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        run = Run(cell, seed, args.device)
        run.setup()
        win = run.window(args.seconds, False)
        run.free()
        if seed in seeds:
            say("program", seed, run.check(win), t0)
        if seed in controls:
            if children:
                say("control " + ",".join(children), seed,
                    run.control(win, children), t0)
            else:
                say("control", seed, run.control(win), t0)
            if args.faults and Run is TrainRun:
                for fault in ("half_batch", "loss_altered"):
                    say(fault, seed, train_fault(run, fault, compare), t0)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


def train_fault(run, fault: str, compare) -> dict:
    """A training fault planted in the reference put in the program's
    place: ``half_batch``, each step on the first half of its batch (the
    mean over the rest); ``loss_altered``, the first step's loss read 1 %
    high where it is produced."""
    from benchmark.lib.cell import lane_of
    from benchmark.lib.weights import make_state
    from benchmark.reference import train as ref_train
    lane = lane_of(run.cell)
    want = run.reference(lane)
    P = make_state(run.shapes, run.cell["config"], run.seed, run.device)
    batches = run.reference_batches()
    if fault == "half_batch":
        half = max(1, batches[0]["x0"].shape[0] // 2)
        batches = [{k: v[:half] for k, v in b.items()} for b in batches]
    got = ref_train.train_steps(run.cell["reference"], run.cell["config"], P,
                                batches, lane)
    if fault == "loss_altered":
        got["losses"][0] *= 1.01
    return compare(got, want)


if __name__ == "__main__":
    sys.exit(main())
