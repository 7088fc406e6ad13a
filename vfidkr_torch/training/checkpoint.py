"""Checkpoints: counterpart of ``vfidkr_tpu/training/checkpoint.py``
(reference ``train.py:51-57,211-218,286-289``).

``filtered_partial_load`` keeps the reference's partial restore: only the
checkpoint entries whose key the model has are loaded, so checkpoints of
ablation variants (extra OccNet or DeconvField weights, PWC-Net's unused
``deconv2``) load into the port.  ``CheckpointManager`` writes
``<dir>/epoch<k>.pth``, deleting the previous epoch's, and ``<dir>/best.pth``;
each holds the full training state: model, Adamax state, plateau, epoch
and the best validation loss so far.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

import torch
from torch import nn

from vfidkr_torch.training.lr_schedule import PlateauState


def filtered_partial_load(model: nn.Module,
                          state_dict: Mapping[str, torch.Tensor]):
    """Load the entries of ``state_dict`` whose key the model has; a shared
    key whose shape differs raises, as the reference's ``load_state_dict``
    does.  Returns (loaded keys, skipped keys)."""
    target = model.state_dict()
    keep, skipped = {}, []
    for key, value in state_dict.items():
        if key not in target:
            skipped.append(key)
            continue
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(value.shape)}, model "
                             f"{tuple(target[key].shape)}")
        keep[key] = value
    model.load_state_dict(keep, strict=False)
    return sorted(keep), sorted(skipped)


def full_state(model: nn.Module, optimizer: torch.optim.Optimizer,
               plateau: PlateauState, epoch: int, best_val: float) -> dict:
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "plateau": plateau._asdict(), "epoch": epoch,
            "best_val": best_val}


def restore_full_state(state: dict, model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> PlateauState:
    """Load a ``full_state`` dict into ``model`` and ``optimizer``; returns
    its plateau state."""
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return PlateauState(**state["plateau"])


class CheckpointManager:
    """Epoch checkpoints with previous-epoch deletion, and best-on-val."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pth")

    def _save(self, name: str, state: dict) -> None:
        # write and rename: an interrupted save never leaves a partial file
        # under the final name
        tmp = self.path(name) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(name))

    def save_epoch(self, epoch: int, state: dict) -> None:
        self._save(f"epoch{epoch}", state)
        prev = self.path(f"epoch{epoch - 1}")
        if os.path.exists(prev):
            os.remove(prev)

    def save_best(self, state: dict) -> None:
        self._save("best", state)

    def load(self, name: str) -> dict:
        return torch.load(self.path(name), map_location="cpu",
                          weights_only=True)

    def latest_epoch(self) -> Optional[int]:
        epochs = [int(m.group(1)) for f in os.listdir(self.directory)
                  if (m := re.fullmatch(r"epoch(\d+)\.pth", f))]
        return max(epochs) if epochs else None
