"""A synthetic-motion dataset in the Vimeo-90K layout: the port's copy of
``tools/make_synthetic_vimeo.py``, written through the port's PNG writer
(no PIL).

Textured frames under rigid translation, whose exact middle frame is the
half shift: the same texture, the same random draws and the same layout
and split files as the JAX package's tool, so for the same ``--seed``,
``--n`` and size the triplets decode to the same pixels.

Layout: ``root/sequences/<seq>/im{1,2,3}.png`` and ``tri_trainlist.txt`` /
``tri_testlist.txt``.

Usage:
  python -m vfidkr_torch.data.synthetic --out /tmp/vimeo_syn --n 64 \\
      [--height 256 --width 448] [--max-shift 6] [--test-frac 0.125] \\
      [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vfidkr_torch.utils.image_io import write_png


def texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A smooth multi-scale random texture, (h, w, 3) float32 in [0, 1]
    (pure noise has no learnable motion signal)."""
    img = np.zeros((h, w, 3), np.float32)
    for scale in (4, 8, 16, 32):
        low = rng.rand(h // scale + 2, w // scale + 2, 3).astype(np.float32)
        ups = np.kron(low, np.ones((scale, scale, 1), np.float32))
        img += ups[:h, :w] / 4.0
    return np.clip(img, 0.0, 1.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=448)
    ap.add_argument("--max-shift", type=int, default=6,
                    help="max |dx|,|dy| between im1 and im3 (even numbers "
                         "keep im2 on the pixel grid)")
    ap.add_argument("--test-frac", type=float, default=0.125)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Write the dataset; returns the sequence names in order."""
    args = parse_args(argv)
    rng = np.random.RandomState(args.seed)
    h, w = args.height, args.width
    m = args.max_shift
    seq_dir = os.path.join(args.out, "sequences")
    names = []
    for i in range(args.n):
        # an oversized texture, three shifted crops
        big = texture(rng, h + 4 * m, w + 4 * m)
        dx = 2 * rng.randint(-m // 2, m // 2 + 1)
        dy = 2 * rng.randint(-m // 2, m // 2 + 1)
        cy, cx = 2 * m, 2 * m
        name = f"{i // 100:05d}/{i % 100:04d}"
        d = os.path.join(seq_dir, name)
        os.makedirs(d, exist_ok=True)
        for j, k in enumerate((-1, 0, 1), start=1):    # im1, im2, im3
            y0, x0 = cy + k * dy // 2, cx + k * dx // 2
            crop = big[y0:y0 + h, x0:x0 + w]
            write_png(os.path.join(d, f"im{j}.png"),
                      np.asarray(np.round(crop * 255), np.uint8))
        names.append(name)

    n_test = max(1, int(args.n * args.test_frac))
    with open(os.path.join(args.out, "tri_trainlist.txt"), "w") as f:
        f.write("\n".join(names[:-n_test]) + "\n")
    with open(os.path.join(args.out, "tri_testlist.txt"), "w") as f:
        f.write("\n".join(names[-n_test:]) + "\n")
    print(f"wrote {args.n} triplets ({args.n - n_test} train / {n_test} "
          f"test) to {args.out}")
    return names


if __name__ == "__main__":
    main()
