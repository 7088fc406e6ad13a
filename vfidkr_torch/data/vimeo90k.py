"""Vimeo-90K triplets as NCHW float32 tensors.

The port's own copy of the JAX package's framework-free pipeline
(``vfidkr_tpu/data/vimeo90k.py:29-197``, reference
``datasets/Vimeo_90K_interp.py``, ``datasets/listdatasets.py`` and
``balancedsampler.py``):

* the split lists ``tri_trainlist.txt`` / ``tri_testlist.txt`` (or the
  reference's renamed ``sep_*`` copies), less their last line, the train
  list shuffled once;
* per sample: a random temporal swap (im1 <-> im3), a random crop to
  256x448 (a no-op at the native size), random left-right and up-down
  flips, drawn in that order from one ``RandomState``;
* a balanced sampler: an endless stream of reshuffled permutations;
* a background prefetch thread.

For the same seed the batches equal the JAX package's.  The JAX package's
optional C++ augment (``native/``) is not used: the Python path makes the
same decisions and the same float32 values.  Batches are dicts of x0 (first
frame), x1 (last frame) and y (the middle frame, the target), (B,3,H,W) in
[0, 1], on the CPU.

Each training epoch draws from a sampler seeded by ``(seed, epoch)``, so a
run resumed at epoch k sees the batches an uninterrupted run sees there.
Decoding the PNG frames needs PIL.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["BalancedSampler", "Vimeo90KDataset", "epoch_seed", "load_triplet",
           "prefetch", "read_triplet_list", "to_tensors", "train_batches",
           "val_batches", "vimeo90k_splits"]

CROP_HW = (256, 448)


def read_triplet_list(root: str, split_file: str) -> List[str]:
    with open(os.path.join(root, split_file)) as f:
        lines = [ln.strip() for ln in f.read().split("\n")]
    # the reference drops the final entry (Vimeo_90K_interp.py:21-24)
    return [ln for ln in lines[:-1] if ln]


def vimeo90k_splits(root: str, train_list: str = "tri_trainlist.txt",
                    test_list: str = "tri_testlist.txt",
                    shuffle_seed: Optional[int] = 0):
    """-> (train_paths, test_paths); the train list shuffled once, as the
    reference does at load (Vimeo_90K_interp.py:25-27)."""
    for cand in (train_list, "sep_trainlist.txt"):
        if os.path.exists(os.path.join(root, cand)):
            train_list = cand
            break
    for cand in (test_list, "sep_testlist.txt"):
        if os.path.exists(os.path.join(root, cand)):
            test_list = cand
            break
    train = read_triplet_list(root, train_list)
    test = read_triplet_list(root, test_list)
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(train)
    return train, test


def _imread(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_triplet(root: str, rel: str, augment: bool,
                 rng: np.random.RandomState,
                 crop_hw: Tuple[int, int] = CROP_HW):
    """One (x0, x1, y) sample, NHWC float32, with the reference
    augmentations."""
    seq = os.path.join(root, "sequences", rel)
    names = ["im1.png", "im2.png", "im3.png"]
    if augment and rng.randint(0, 2):
        names = names[::-1]                          # temporal swap
    first, mid, last = (_imread(os.path.join(seq, n)) for n in names)

    ch, cw = crop_hw
    h, w = first.shape[:2]
    oy = rng.randint(0, h - ch + 1) if h > ch else 0
    ox = rng.randint(0, w - cw + 1) if w > cw else 0
    first, mid, last = (im[oy:oy + ch, ox:ox + cw] for im in (first, mid, last))

    if augment:
        if rng.randint(0, 2):
            first, mid, last = (np.fliplr(im) for im in (first, mid, last))
        if rng.randint(0, 2):
            first, mid, last = (np.flipud(im) for im in (first, mid, last))

    to_f32 = lambda im: np.ascontiguousarray(im, dtype=np.float32) / 255.0
    return to_f32(first), to_f32(last), to_f32(mid)


class BalancedSampler:
    """Endless stream of reshuffled permutations (balancedsampler.py:4-31)."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.rng = np.random.RandomState(seed)
        self._perm = self.rng.permutation(n)
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self._pos >= self.n:
            self._perm = self.rng.permutation(self.n)
            self._pos = 0
        idx = int(self._perm[self._pos])
        self._pos += 1
        return idx


class Vimeo90KDataset:
    """Batches of triplets, NHWC float32: dict(x0=im1, x1=im3, y=im2)."""

    def __init__(self, root: str, paths: Sequence[str], batch_size: int,
                 augment: bool = True, seed: int = 0,
                 crop_hw: Tuple[int, int] = CROP_HW):
        self.root = root
        self.paths = list(paths)
        self.batch_size = batch_size
        self.augment = augment
        self.crop_hw = crop_hw
        self.rng = np.random.RandomState(seed)
        self.sampler = BalancedSampler(len(self.paths), seed)

    def __len__(self):
        return len(self.paths)

    def _make_batch(self, idxs):
        samples = [load_triplet(self.root, self.paths[i], self.augment,
                                self.rng, self.crop_hw) for i in idxs]
        x0, x1, y = (np.stack(s) for s in zip(*samples))
        return {"x0": x0, "x1": x1, "y": y}

    def batches(self, num_batches: Optional[int] = None,
                sequential: bool = False) -> Iterator[dict]:
        produced = 0
        seq_pos = 0
        while num_batches is None or produced < num_batches:
            if sequential:
                if seq_pos + self.batch_size > len(self.paths):
                    return
                idxs = range(seq_pos, seq_pos + self.batch_size)
                seq_pos += self.batch_size
            else:
                idxs = [next(self.sampler) for _ in range(self.batch_size)]
            yield self._make_batch(idxs)
            produced += 1


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, ``size`` items ahead; its
    exceptions are raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


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
