#!/usr/bin/env python3
"""The port's PNG decode on the host, on the frames users feed it.

    python3 tools/bench_png.py [--other PATH ...] [--reps 5]

Times ``vfidkr_torch.utils.image_io.read_png`` (median of ``--reps``, host
clock) on chip_smoke.py's smooth scene at 1280x720 and at Vimeo-90K's
448x256, each frame encoded twice: its rows filtered as PIL's encoder
filters them (``tests/torch_png.pil_kinds``: mostly Paeth rows, so the
diagonal decode) and as the port's own writer writes it (Up rows); and the
nine PIL-filtered 448x256 frames of one B=3 train step, read one after
another.  With ``--other PATH`` (repeatable) it also times an earlier
``image_io.py`` at PATH, the versions taking turns in each repetition.
Every decode is checked against its frame.  It needs no card; it prints the
host's CPU count, and the card's name and power limit where nvidia-smi
answers.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import make_clip, torch_png  # noqa: E402
from vfidkr_torch.utils import image_io  # noqa: E402


def load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"image_io_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="an earlier image_io.py to time beside this one")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = "no card"
    print(f"[png] host CPUs {os.cpu_count()}; card {card or 'no card'}")
    versions = {"this tree": image_io}
    versions.update({str(p): load(Path(p)) for p in args.other})
    g = torch.Generator().manual_seed(1)
    big = make_clip(g, 1, 720, 1280)[0]
    step = make_clip(g, 9, 256, 448)
    with tempfile.TemporaryDirectory(prefix="bench_png_") as tmp:
        tmp = Path(tmp)
        cases = {}
        for label, frames in (("1280x720", [big]), ("448x256", step[:1]),
                              ("9 x 448x256 (a train step)", step)):
            for enc in ("PIL-filtered", "Up rows"):
                if enc == "Up rows" and len(frames) > 1:
                    continue
                paths = []
                for k, frame in enumerate(frames):
                    path = tmp / f"{len(cases)}_{k}.png"
                    if enc == "Up rows":
                        image_io.write_png(path, frame)
                    else:
                        path.write_bytes(torch_png.png_bytes(frame, "pil"))
                    paths.append(path)
                cases[f"{label}, {enc}"] = (paths, frames)
        for case, (paths, frames) in cases.items():
            times = {name: [] for name in versions}
            for _ in range(args.reps):
                for name, mod in versions.items():
                    t = time.perf_counter()
                    got = [mod.read_png(p) for p in paths]
                    times[name].append(time.perf_counter() - t)
                    if not all(np.array_equal(a, b)
                               for a, b in zip(got, frames)):
                        raise AssertionError(f"{name}: {case} decodes wrong")
            print(f"[png] read_png {case}: " + "; ".join(
                f"{name} {statistics.median(ts) * 1000:.3f} ms (min "
                f"{min(ts) * 1000:.3f})" for name, ts in times.items()))


if __name__ == "__main__":
    main()
