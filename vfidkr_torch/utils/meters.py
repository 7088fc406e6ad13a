"""Streaming scalar statistics for timing and metric logs: counterpart of
``vfidkr_tpu/utils/meters.py`` (the reference's ``AverageMeter.py``), an
incremental mean that stays stable over long streams."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunningMean:
    """Online mean over a stream of (value, weight) observations."""

    mean: float = 0.0
    weight: float = 0.0
    last: float = 0.0

    def update(self, value: float, n: float = 1) -> None:
        self.last = float(value)
        self.weight += n
        if self.weight > 0:      # n = 0 (an empty batch) records `last` only
            self.mean += (self.last - self.mean) * (n / self.weight)

    def reset(self) -> None:
        self.mean = self.weight = self.last = 0.0

    # the reference's names
    @property
    def avg(self) -> float:
        return self.mean

    @property
    def val(self) -> float:
        return self.last


AverageMeter = RunningMean
