"""ReduceLROnPlateau as one learning-rate scale: counterpart of
``vfidkr_tpu/training/lr_schedule.py`` (reference ``lr_scheduler.py:167-308``
with mode 'min', relative threshold 1e-4, ``train.py:97``).

The reference reduces every parameter group by the same factor, so a single
multiplier ``scale`` on top of each group's base learning rate is the same
schedule.
"""

from __future__ import annotations

import math
from typing import NamedTuple


class PlateauState(NamedTuple):
    scale: float = 1.0            # current learning-rate multiplier
    best: float = math.inf        # best metric seen
    num_bad_epochs: int = 0
    cooldown_counter: int = 0


def plateau_init() -> PlateauState:
    return PlateauState()


def plateau_step(state: PlateauState, metric: float, factor: float = 0.2,
                 patience: int = 3, threshold: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 0.0) -> PlateauState:
    """One ``scheduler.step(metric)`` in 'min' mode with a relative
    threshold."""
    metric = float(metric)
    is_better = metric < state.best * (1.0 - threshold)
    best = metric if is_better else state.best
    in_cooldown = state.cooldown_counter > 0
    num_bad = 0 if is_better or in_cooldown else state.num_bad_epochs + 1
    cooldown_counter = max(state.cooldown_counter - 1, 0)
    scale = state.scale
    if num_bad > patience:
        scale = max(state.scale * factor, min_scale)
        cooldown_counter = cooldown
        num_bad = 0
    return PlateauState(scale=scale, best=best, num_bad_epochs=num_bad,
                        cooldown_counter=cooldown_counter)
