"""Vimeo-90K triplets as NCHW float32 tensors.

A thin wrapper over the JAX package's framework-free pipeline
(``vfidkr_tpu.data.vimeo90k``, which imports numpy and PIL and no JAX): the
split lists, balanced sampling, the reference's augmentations and the
background prefetch are its own.  Batches are dicts of x0 (first frame), x1
(last frame) and y (the middle frame, the target), (B,3,H,W) in [0, 1], on
the CPU.

Each training epoch draws from a sampler seeded by ``(seed, epoch)``, so a
run resumed at epoch k sees the batches an uninterrupted run sees there.
Decoding the PNG frames needs PIL.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from vfidkr_tpu.data.vimeo90k import (Vimeo90KDataset, prefetch,
                                      vimeo90k_splits)

__all__ = ["epoch_seed", "to_tensors", "train_batches", "val_batches",
           "vimeo90k_splits"]


def epoch_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def to_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """NHWC float32 arrays -> contiguous NCHW tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in batch.items()}


def train_batches(root: str, paths: Sequence[str], batch_size: int,
                  num_batches: int, seed: int,
                  epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
    """One epoch of augmented, balanced-sampled training batches."""
    ds = Vimeo90KDataset(root, paths, batch_size, augment=True,
                         seed=epoch_seed(seed, epoch))
    return prefetch((to_tensors(b) for b in ds.batches(num_batches)), 2)


def val_batches(root: str, paths: Sequence[str], batch_size: int,
                num_batches: int) -> Iterator[Dict[str, torch.Tensor]]:
    """The first ``num_batches`` validation batches, in order, unaugmented."""
    ds = Vimeo90KDataset(root, paths, batch_size, augment=False)
    return prefetch((to_tensors(b)
                     for b in ds.batches(num_batches, sequential=True)), 2)
