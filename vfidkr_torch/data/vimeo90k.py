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
* a background prefetch thread;
* optionally, a pool of worker processes that decode a batch's frames
  (``decode_pool``): a frame whose rows are Average- or Paeth-filtered, as
  PIL's and most encoders' are, takes the decoder's diagonal walk, and a
  batch's nine of them on one thread take longer than a train step.

For the same seed the batches equal the JAX package's.  A batch's swap,
crop, flips and ``u8 / 255`` run in the port's C++/OpenMP augment
(``vfidkr_torch.data.native``, built at first use; it raises where it
cannot be built), which writes the batch's tensors directly; the Python
path (``augment_triplet``) is its plain version and no batch falls back to
it.  Batches are dicts of x0 (first frame), x1 (last frame) and y (the
middle frame, the target), (B,3,H,W) float32 tensors in [0, 1], on the CPU.

Each training epoch draws from a sampler seeded by ``(seed, epoch)``, so a
run resumed at epoch k sees the batches an uninterrupted run sees there.
The frames are decoded by ``vfidkr_torch.utils.image_io`` (PNG without
PIL); the augmentation's random draws stay in the calling thread, in the
reference's order, wherever the frames are decoded.
"""

from __future__ import annotations

import contextlib
import ctypes
import multiprocessing
import os
import queue
import signal
import threading
from concurrent.futures import Executor, ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vfidkr_torch.config import DataConfig
from vfidkr_torch.data import native
from vfidkr_torch.utils.image_io import frame_size, read_rgb

__all__ = ["BalancedSampler", "DATASETS", "Vimeo90KDataset",
           "apply_augment", "augment_triplet", "decode_pool", "draw_augment", "epoch_seed", "load_triplet",
           "prefetch", "read_frames", "read_triplet_list", "train_batches",
           "val_batches", "vimeo90k_splits"]

CROP_HW = DataConfig.crop_hw


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


# DataConfig.dataset_name -> the reader of its (train, test) splits (the
# reference looks its --datasetName up among its datasets, my_args.py:18)
DATASETS = {"Vimeo_90K_interp": vimeo90k_splits}


TRIPLET = ("im1.png", "im2.png", "im3.png")


def _die_with_parent(prctl, parent: int) -> None:
    """A decode worker's initializer: on Linux, be killed when the thread
    that forked it ends (the trainer's main thread), so a killed trainer
    leaves no worker behind."""
    if prctl is None:                      # not Linux: no PR_SET_PDEATHSIG
        return
    prctl(1, signal.SIGKILL)
    if os.getppid() != parent:             # it ended before the prctl
        os._exit(0)


@contextlib.contextmanager
def decode_pool(workers: int):
    """A pool of ``workers`` processes that decode frames, or None for 0.
    The workers are forked at once from the calling thread (the main
    thread: each dies with it) and only decode (numpy and zlib: they touch
    no CUDA state); they are shut down on leaving the context."""
    if workers <= 0:
        yield None
        return
    try:   # resolved here: a forked child then loads no symbol
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        prctl = None
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("fork"),
        initializer=_die_with_parent, initargs=(prctl, os.getpid()))
    try:
        pool.submit(int).result()          # every worker forked here
        yield pool
    finally:
        pool.shutdown(cancel_futures=True)


def read_frames(paths: Sequence[str], pool: Optional[Executor] = None
                ) -> List[np.ndarray]:
    """(H, W, 3) uint8 frames of ``paths``, in order, decoded in ``pool``
    where one is given."""
    if pool is None:
        return [read_rgb(p) for p in paths]
    return list(pool.map(read_rgb, paths))


def draw_augment(hw: Tuple[int, int], augment: bool,
                 rng: np.random.RandomState,
                 crop_hw: Tuple[int, int] = CROP_HW) -> tuple:
    """The augmentation of one triplet of (h, w) frames, drawn from ``rng``
    in the reference's order: (swap, oy, ox, fliplr, flipud)."""
    swap = bool(augment and rng.randint(0, 2))       # temporal swap
    ch, cw = crop_hw
    h, w = hw
    oy = rng.randint(0, h - ch + 1) if h > ch else 0
    ox = rng.randint(0, w - cw + 1) if w > cw else 0
    lr = bool(augment and rng.randint(0, 2))
    ud = bool(augment and rng.randint(0, 2))
    return swap, oy, ox, lr, ud


def augment_triplet(frames: Sequence[np.ndarray], augment: bool,
                    rng: np.random.RandomState,
                    crop_hw: Tuple[int, int] = CROP_HW):
    """im1, im2, im3 -> one (x0, x1, y) sample, NHWC float32, with the
    reference augmentations, drawn from ``rng`` in the reference's order."""
    return apply_augment(frames, draw_augment(frames[0].shape[:2], augment,
                                              rng, crop_hw), crop_hw)


def apply_augment(frames: Sequence[np.ndarray], record: Sequence[int],
                  crop_hw: Tuple[int, int] = CROP_HW):
    """im1, im2, im3 and a record (swap, oy, ox, fliplr, flipud) -> one
    (x0, x1, y) sample, NHWC float32: the plain version of the C++
    augment's data movement."""
    first, mid, last = frames
    swap, oy, ox, lr, ud = record
    if swap:
        first, last = last, first
    ch, cw = crop_hw
    first, mid, last = (im[oy:oy + ch, ox:ox + cw] for im in (first, mid, last))
    if lr:
        first, mid, last = (np.fliplr(im) for im in (first, mid, last))
    if ud:
        first, mid, last = (np.flipud(im) for im in (first, mid, last))

    to_f32 = lambda im: np.ascontiguousarray(im, dtype=np.float32) / 255.0
    return to_f32(first), to_f32(last), to_f32(mid)


def load_triplet(root: str, rel: str, augment: bool,
                 rng: np.random.RandomState,
                 crop_hw: Tuple[int, int] = CROP_HW):
    """One (x0, x1, y) sample, NHWC float32, with the reference
    augmentations."""
    seq = os.path.join(root, "sequences", rel)
    return augment_triplet(read_frames([os.path.join(seq, n)
                                        for n in TRIPLET]),
                           augment, rng, crop_hw)


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
    """Batches of triplets, (B,3,H,W) float32 tensors: dict(x0=im1, x1=im3,
    y=im2), made by the C++ augment (``native.augment_triplets``).

    With ``shard`` (a range of batch positions: a data-parallel rank's
    share) each batch holds only those samples of the global batch, and
    only their frames are decoded; the others' augmentations are still
    drawn, from their frames' sizes, so that every rank's random draws
    stay those of the whole batch."""

    def __init__(self, root: str, paths: Sequence[str], batch_size: int,
                 augment: bool = True, seed: int = 0,
                 crop_hw: Tuple[int, int] = CROP_HW,
                 pool: Optional[Executor] = None,
                 shard: Optional[range] = None):
        self.root = root
        self.pool = pool
        self.paths = list(paths)
        self.batch_size = batch_size
        self.augment = augment
        self.crop_hw = crop_hw
        self.shard = range(batch_size) if shard is None else shard
        self.rng = np.random.RandomState(seed)
        self.sampler = BalancedSampler(len(self.paths), seed)

    def __len__(self):
        return len(self.paths)

    def _path(self, i, name):
        return os.path.join(self.root, "sequences", self.paths[i], name)

    def _make_batch(self, idxs):
        idxs = list(idxs)
        own = [idxs[k] for k in self.shard]
        frames = read_frames([self._path(i, n) for i in own for n in TRIPLET],
                             self.pool)
        triplets = [frames[j:j + 3] for j in range(0, len(frames), 3)]
        records = []
        for k, i in enumerate(idxs):
            owned = k in self.shard
            hw = (triplets[len(records)][0].shape[:2] if owned
                  else frame_size(self._path(i, TRIPLET[0])))
            rec = draw_augment(hw, self.augment, self.rng, self.crop_hw)
            if owned:
                records.append(rec)
        return native.augment_triplets(triplets, records, self.crop_hw)

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


def train_batches(root: str, paths: Sequence[str], batch_size: int,
                  num_batches: int, seed: int, epoch: int,
                  pool: Optional[Executor] = None,
                  shard: Optional[range] = None,
                  crop_hw: Tuple[int, int] = CROP_HW,
                  augment: bool = DataConfig.augment_train
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """One epoch of balanced-sampled training batches, augmented unless
    ``augment`` is false (``shard`` of each, see ``Vimeo90KDataset``)."""
    ds = Vimeo90KDataset(root, paths, batch_size, augment=augment,
                         seed=epoch_seed(seed, epoch), crop_hw=crop_hw,
                         pool=pool, shard=shard)
    return prefetch(ds.batches(num_batches), 2)


def val_batches(root: str, paths: Sequence[str], batch_size: int,
                num_batches: int, pool: Optional[Executor] = None,
                shard: Optional[range] = None,
                crop_hw: Tuple[int, int] = CROP_HW
                ) -> Iterator[Dict[str, torch.Tensor]]:
    """The first ``num_batches`` validation batches, in order, unaugmented
    (``shard`` of each)."""
    ds = Vimeo90KDataset(root, paths, batch_size, augment=False,
                         crop_hw=crop_hw, pool=pool, shard=shard)
    return prefetch(ds.batches(num_batches, sequential=True), 2)
