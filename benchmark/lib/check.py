"""The numbers that decide ``correct``, and their limits.

Evaluation cells (per sampled pair, the program's kept outputs against the
reference's on the same two frames):

* ``u8_mismatch``: the share of the delivered uint8 values (every frame of
  every sampled pair) that differ from the reference's;
* ``f32_rel_rms``: the largest, over the sampled pairs, of the RMS of the
  model's float32 output minus the reference's, over the RMS of the
  reference's (all synthesised frames of the pair, padded).  In a float32
  cell a landing whose column or row meets an integer takes the next 4x4
  window, and the filter's output jumps there, so a seed whose flow sits
  near an integer reads far higher than the others: it is printed there,
  not limited.  The bf16 lane's rounding lies far above those jumps, and
  its cell limits it.

Training cells (the set-up's first three steps, through the window's own
step and feed, against the reference's three steps from the same weights
and batches):

* ``loss1_gap``: the relative gap of the first step's loss (``loss_gap``:
  the largest over the three steps);
* ``grad_gap``: the largest, over the leaves, gap between the norm of the
  first gradient as the optimizer got it (worked out from its state after
  one step) and the reference's, over the reference's norm of that leaf or
  of the median leaf, whichever is larger;
* ``change_median_gap``: the median leaf's gap of the same kind of the
  parameters' change over the three steps (``change_gap``: the worst
  leaf's), leaving out leaves whose reference gradient norm is under a
  thousandth of the median leaf's (they move under Adamax by round-off
  alone).

A run is correct where every number that the cell's ``workloads/<cell>.json``
limits is at or under its limit and something was compared; the others
are printed beside them for information.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def eval_numbers(got: list, want: list) -> dict:
    """``got``, ``want``: per sampled pair, (float32 outputs, uint8
    frames)."""
    if not got:
        return {}
    rel, diff, total = 0.0, 0, 0
    for (g32, g8), (w32, w8) in zip(got, want):
        num = sum(float(((a.float() - b.float()) ** 2).sum())
                  for a, b in zip(g32, w32))
        den = sum(float((b.float() ** 2).sum()) for b in w32)
        if len(g32) != len(w32) or g8.shape != w8.shape:
            return {"f32_rel_rms": math.inf, "u8_mismatch": 1.0}
        rel = max(rel, math.sqrt(num / max(den, 1e-30)))
        diff += int(np.count_nonzero(g8 != w8))
        total += g8.size
    return {"f32_rel_rms": rel, "u8_mismatch": diff / total}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def norm_gap(got: dict, want: dict, leaves=None, over=max) -> float:
    """``over`` (the worst, or the median) leaf of |‖got‖ - ‖want‖| /
    max(‖want‖, median leaf ‖want‖)."""
    g, w = _norms(got), _norms(want)
    keys = list(w) if leaves is None else list(leaves)
    if not keys or set(keys) - set(g):
        return math.inf
    med = statistics.median(w[k] for k in keys)
    return over([abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys])


def train_numbers(losses: list, ref_losses: list, grad1: dict,
                  ref_grad1: dict, change: dict, ref_change: dict) -> dict:
    if not ref_losses:
        return {}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(losses, ref_losses)]
    if len(losses) != len(ref_losses):
        gaps = [math.inf]
    g = _norms(ref_grad1)
    med = statistics.median(g.values())
    live = [k for k, v in g.items() if v >= 1e-3 * med]
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": norm_gap(grad1, ref_grad1),
            "change_median_gap": norm_gap(change, ref_change, live,
                                          statistics.median),
            "change_gap": norm_gap(change, ref_change, live)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every limit's number present,
    finite and at or under it."""
    table = {}
    for k, v in limits.items():
        value = numbers.get(k)
        finite = value is not None and math.isfinite(value)
        # a number that is missing or not finite prints as null
        table[k] = {"value": value if finite else None, "limit": v}
    ok = bool(numbers) and all(t["value"] is not None and
                               t["value"] <= t["limit"]
                               for t in table.values())
    return ok, table
