"""The port's copy of the Vimeo-90K pipeline (vfidkr_torch.data.vimeo90k)
gives the JAX package's batches (as NCHW tensors, made by the port's C++
augment), on a synthetic 64x64 tree written by
tools/make_synthetic_vimeo.py: the split lists, a few augmented training
batches from one seed, and the sequential validation batches, equal to the
last bit, with the frames decoded on the prefetch thread or in worker
processes.  The port's copy of that tool (vfidkr_torch.data.synthetic)
writes the same tree, pixel for pixel.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vfidkr_tpu.data.vimeo90k as J  # noqa: E402

import vfidkr_torch.data.vimeo90k as V  # noqa: E402
from vfidkr_torch.data import synthetic  # noqa: E402
from vfidkr_torch.utils.image_io import read_png  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("vimeo")
    subprocess.run([sys.executable, "tools/make_synthetic_vimeo.py",
                    "--out", str(root), "--n", "8", "--height", "64",
                    "--width", "64", "--test-frac", "0.25"],
                   cwd=REPO, check=True, capture_output=True, timeout=120)
    return str(root)


def test_splits_match_jax(dataset):
    assert V.vimeo90k_splits(dataset) == J.vimeo90k_splits(dataset)
    train, test = V.vimeo90k_splits(dataset)
    assert len(train) == 6 and len(test) == 2


@pytest.mark.parametrize("augment,sequential", [(True, False), (False, True)])
def test_batches_match_jax(dataset, augment, sequential):
    train, test = V.vimeo90k_splits(dataset)
    paths = test if sequential else train
    kw = dict(batch_size=2, augment=augment, seed=7, crop_hw=(64, 64))
    got = list(V.Vimeo90KDataset(dataset, paths, **kw).batches(
        5, sequential=sequential))
    want = list(J.Vimeo90KDataset(dataset, paths, **kw).batches(
        5, sequential=sequential))
    assert len(got) == len(want) == (1 if sequential else 5)
    for a, b in zip(got, want):
        assert a.keys() == b.keys() == {"x0", "x1", "y"}
        for k in a:
            assert a[k].dtype == torch.float32 and b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k].numpy(),
                                          b[k].transpose(0, 3, 1, 2),
                                          err_msg=k)


def test_train_batches_are_the_tensors_of_jax_batches(dataset):
    """The trainer's epoch stream: the JAX package's batches for the epoch's
    seed, as NCHW tensors."""
    train, _ = V.vimeo90k_splits(dataset)
    got = list(V.train_batches(dataset, train, 2, 3, seed=3, epoch=1))
    ds = J.Vimeo90KDataset(dataset, train, 2, augment=True,
                           seed=V.epoch_seed(3, 1))
    want = list(ds.batches(3))
    assert len(got) == 3
    for a, b in zip(got, want):
        for k in ("x0", "x1", "y"):
            np.testing.assert_array_equal(a[k].numpy(),
                                          b[k].transpose(0, 3, 1, 2))


def test_decode_workers_give_the_same_batches(dataset):
    """Frames decoded in a pool of worker processes (the trainer's, on the
    card) give the JAX package's batches, training and validation, as on
    the prefetch thread."""
    train, test = V.vimeo90k_splits(dataset)
    with V.decode_pool(2) as pool:
        got = list(V.train_batches(dataset, train, 2, 3, seed=3, epoch=1,
                                   pool=pool))
        got_val = list(V.val_batches(dataset, test, 2, 1, pool=pool))
    want = list(J.Vimeo90KDataset(dataset, train, 2, augment=True,
                                  seed=V.epoch_seed(3, 1)).batches(3))
    want_val = list(J.Vimeo90KDataset(dataset, test, 2, augment=False)
                    .batches(1, sequential=True))
    assert len(got) == 3 and len(got_val) == 1
    for a, b in zip(got + got_val, want + want_val):
        for k in ("x0", "x1", "y"):
            np.testing.assert_array_equal(a[k].numpy(),
                                          b[k].transpose(0, 3, 1, 2))


def test_synthetic_writes_what_the_jax_tool_writes(dataset, tmp_path):
    """The same seed, count, size and split: the same split files and
    sequence names, each frame decoding to the same pixels (the JAX tool's
    PNGs read by PIL, the port's by its own reader)."""
    from PIL import Image
    names = synthetic.main(["--out", str(tmp_path), "--n", "8", "--height",
                            "64", "--width", "64", "--test-frac", "0.25"])
    assert len(names) == 8
    for split in ("tri_trainlist.txt", "tri_testlist.txt"):
        assert (tmp_path / split).read_text() == \
            (Path(dataset) / split).read_text()
    for name in names:
        for j in (1, 2, 3):
            rel = Path("sequences", name, f"im{j}.png")
            with Image.open(Path(dataset) / rel) as im:
                want = np.asarray(im)
            np.testing.assert_array_equal(read_png(tmp_path / rel), want)
