"""The trainer from disk on the card, one checkout at a time, for an A/B of
two checkouts on one card.

Runs the ``phase_train_from_disk`` of the checkout's own ``chip_smoke.py``
with that checkout's ``vfidkr_torch``, after its ``phase_device`` (TF32 off):
``apps.train`` on 18 synthetic 256x448 triplets re-encoded with PIL's row
filters, 2 epochs of 4 steps and a ``--resume``, then ms/step over 2 epochs
of 10 steps several ways (4 decode workers, the prefetch thread, Up rows;
in checkouts that have it, cuDNN's TF32 at PyTorch's default).  The phase
prints its ``[times]`` lines; its in-memory column reads ``nan`` here (the
train phase that measures it is not run).  ``--tf32`` sets cuDNN's TF32
flag back to PyTorch's default (the apps') for the whole phase.

Where the checkout has the C++ host augment (``vfidkr_torch.data.native``),
``--augment-threads N`` runs it on N OpenMP threads a call instead of
``native.thread_count()``, and ``--augment-times`` first prints its host ms
a batch (B = 3 and 12, 256x448 crops of decoded frames, median of 20) at
1, 2, 4 and every CPU's threads.  ``OMP_WAIT_POLICY`` and the like are read
from the environment by the OpenMP runtime, as always.
``--sweep-threads 1,2,4,8`` runs, instead of the phase, the trainer from
disk (the phase's PIL-filtered triplets, 4 decode workers, 3 epochs of 20
steps; epochs 1 and 2 the readings) at each thread count, with TF32 off
and at PyTorch's default, in ``--rounds`` interleaved rounds in one
process, and prints each setting's readings and their median.

Run each reading in its own process and alternate the checkouts (parent,
change, change, parent), e.g. with the parent unpacked by ``git archive``
into ``build/parent``:

  python3 tools/ab_train_from_disk.py --root build/parent
  python3 tools/ab_train_from_disk.py --augment-times
  python3 tools/ab_train_from_disk.py --augment-threads 2
  OMP_WAIT_POLICY=passive python3 tools/ab_train_from_disk.py
"""

from __future__ import annotations

import argparse
import inspect
import math
import os
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def augment_times(native, threads, reps: int = 20) -> None:
    import numpy as np
    from vfidkr_torch.data import vimeo90k
    h, w = vimeo90k.CROP_HW
    rng = np.random.RandomState(0)
    for b in (3, 12):
        trips = [[rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                  for _ in range(3)] for _ in range(b)]
        recs = [vimeo90k.draw_augment((h, w), True, rng) for _ in trips]
        for t in threads:
            native.thread_count = lambda t=t: t
            native.augment_triplets(trips, recs, (h, w))
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                native.augment_triplets(trips, recs, (h, w))
                ms.append((time.perf_counter() - t0) * 1000)
            print(f"[ab] host augment, B={b} {h}x{w}, {t} threads: "
                  f"{statistics.median(ms):.3f} ms a batch (median of "
                  f"{reps}, host clock)", flush=True)


def sweep(cs, native, dev, card, tf32_default, rounds, threads,
          steps: int = 20) -> None:
    import tempfile
    import torch
    from vfidkr_torch.apps import train as train_app
    from vfidkr_torch.data import synthetic
    count = native.thread_count
    readings = {}
    with tempfile.TemporaryDirectory(prefix="vfidkr_ab_") as tmp:
        up, data = Path(tmp) / "up", Path(tmp) / "vimeo"
        synthetic.main(["--out", str(up), "--n", str(cs.DISK_TRIPLETS),
                        "--height", str(cs.DISK_HW[0]), "--width",
                        str(cs.DISK_HW[1]), "--test-frac", "0.34"])
        for src in sorted(up.rglob("*")):
            dst = data / src.relative_to(up)
            if src.is_dir():
                dst.mkdir(parents=True, exist_ok=True)
            elif src.suffix == ".png":
                cs.write_pil_filtered(dst, cs.read_png(src))
            else:
                dst.write_bytes(src.read_bytes())
        for r in range(rounds):
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32 and tf32_default
                for t in threads:
                    native.thread_count = lambda t=t: t
                    save = Path(tmp) / f"run{r}_{tf32}_{t}"
                    _, out, _ = cs._run_captured(
                        "ab", train_app.main, cs._train_argv(data, save, dev)
                        + ["--num-epochs", "3", "--steps-per-epoch",
                           str(steps)])
                    per = cs._epoch_ms_per_step(out, steps)
                    readings.setdefault((tf32, t), []).extend(
                        [per[1], per[2]])
    native.thread_count = count
    torch.backends.cudnn.allow_tf32 = False
    for (tf32, t), ms in readings.items():
        print(f"[ab] {card}: DAIN train step from disk, B={cs.TRAIN_B} "
              f"{cs.DISK_HW[0]}x{cs.DISK_HW[1]}, PIL-filtered PNGs, 4 decode "
              f"workers, cudnn.allow_tf32={tf32 and tf32_default}, C++ "
              f"augment on {t} threads: median "
              f"{statistics.median(ms):.3f} ms/step of "
              f"{', '.join(f'{x:.3f}' for x in ms)} (epochs 1-2 of 3 x "
              f"{steps} steps, {rounds} rounds, host clock)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="the checkout whose chip_smoke.py and vfidkr_torch "
                         "run (default: this one)")
    ap.add_argument("--augment-threads", type=int, default=None)
    ap.add_argument("--augment-times", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--sweep-threads", default=None,
                    help="comma-separated thread counts")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    tf32_default = torch.backends.cudnn.allow_tf32
    import chip_smoke as cs
    import vfidkr_torch
    try:
        from vfidkr_torch.data import native
    except ImportError:
        native = None
    dev = cs.phase_device()
    if args.tf32:
        torch.backends.cudnn.allow_tf32 = tf32_default
    card = cs.card_label()
    threads = "none (no C++ augment)"
    if native is not None:
        cpus = len(os.sched_getaffinity(0))
        if args.augment_times:
            count = native.thread_count
            augment_times(native, sorted({1, 2, 4, cpus}))
            native.thread_count = count
        if args.augment_threads is not None:
            native.thread_count = lambda: args.augment_threads
        threads = (f"{native.thread_count()} threads a call (OMP_WAIT_POLICY="
                   f"{os.environ.get('OMP_WAIT_POLICY')})")
    print(f"[ab] {card}: {vfidkr_torch.__file__}: the trainer from disk, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; C++ augment "
          f"{threads}", flush=True)
    if args.sweep_threads:
        sweep(cs, native, dev, card, tf32_default, args.rounds,
              [int(t) for t in args.sweep_threads.split(",")])
        return
    phase = cs.phase_train_from_disk
    kwargs = {"card": card} if "card" in inspect.signature(
        phase).parameters else {}
    t0 = time.perf_counter()
    phase(dev, math.nan, **kwargs)
    print(f"[ab] {root.name or root}: the phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
