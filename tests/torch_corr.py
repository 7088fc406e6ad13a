"""K13 (``correlation``, PWC-Net's cost volume and its LeakyReLU) at the
shapes PWC-Net runs it, and its float64 yardstick, shared by the card-only
tests, ``chip_smoke.py`` and ``tools/bench_k13.py``."""
import torch

from vfidkr_torch.ops import correlation as CV

# PWC-Net's feature channels at levels 2 .. 6
LEVEL_C = {2: 32, 3: 64, 4: 96, 5: 128, 6: 196}
# (label, N, C, H, W): every level's map of cells 1 and 4 (a 512 x 320
# pair), 5 (B = 40 at 256 x 448, both directions: batch 80) and 8 (a
# 1984 x 1152 pair)
LEVELS = tuple((f"{cell} L{lvl}", n, LEVEL_C[lvl], hh >> lvl, ww >> lvl)
               for cell, n, hh, ww in (("cells 1, 4", 2, 320, 512),
                                       ("cell 5", 80, 256, 448),
                                       ("cell 8", 2, 1152, 1984))
               for lvl in (2, 3, 4, 5, 6))
# ragged tiles (W % 4 != 0, H not a multiple of 4 or 8), C = 1 and C that
# no stage of 8 or 4 channels divides
RAGGED = (("ragged", 2, 13, 37, 75), ("C = 1", 1, 1, 5, 9),
          ("C = 1 ragged", 2, 1, 11, 33), ("odd C", 3, 37, 12, 64),
          ("C = 196, W % 4 = 2", 2, 196, 9, 30))
CASES = LEVELS + RAGGED
# float32 sums of 32-196 channels, or of 81 displacements, in another order
# read about 1e-7 of the terms' magnitudes; a dropped or misplaced term
# reads 1e-2 or more
TOL = 1e-5


def inputs(n, c, h, w, seed, device="cpu"):
    """(f1, f2, the output's gradient), standard normal, drawn on the CPU
    from ``seed`` and moved to ``device``."""
    g = torch.Generator().manual_seed(seed)
    return tuple(t.to(device) for t in (
        torch.randn(n, c, h, w, generator=g),
        torch.randn(n, c, h, w, generator=g),
        torch.randn(n, CV.NCORR, h, w, generator=g)))


def errors(f1, f2, g, out, gf1, gf2) -> dict:
    """{"out", "grad_f1", "grad_f2": (max error over the float64 sum of the
    terms' magnitudes, max |kernel - float64|)} of K13's forward ``out`` and
    its gradients given ``g``, against the float64 plain versions.  The
    gradients' yardstick runs on the same ``out``: its sign sets the slope,
    and a value within rounding of 0 may take the other sign in float64."""
    d1, d2, dg = f1.double(), f2.double(), g.double()
    want = {"out": CV.cost_volume_plain(d1, d2)}
    mag = {"out": CV.correlation_cost_volume(d1.abs(), d2.abs(), CV.MD)}
    want["grad_f1"], want["grad_f2"] = CV.cost_volume_bwd_plain(
        d1, d2, out.double(), dg)
    # each gradient's terms' magnitudes: |G| at slope 1 times |f|
    mag["grad_f1"], mag["grad_f2"] = CV.cost_volume_bwd_plain(
        d1.abs(), d2.abs(), torch.ones_like(dg), dg.abs())
    got = {"out": out, "grad_f1": gf1, "grad_f2": gf2}
    res = {}
    for key, x in got.items():
        err = (x.double() - want[key]).abs()
        res[key] = ((err / mag[key].clamp(min=1e-30)).max().item(),
                    err.max().item())
    return res
