"""The port's copy of the Vimeo-90K pipeline (vfidkr_torch.data.vimeo90k)
gives the JAX package's batches, on a synthetic 64x64 tree written by
tools/make_synthetic_vimeo.py: the split lists, a few augmented training
batches from one seed, and the sequential validation batches, equal to the
last bit.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vfidkr_tpu.data.vimeo90k as J  # noqa: E402

import vfidkr_torch.data.vimeo90k as V  # noqa: E402

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
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


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
