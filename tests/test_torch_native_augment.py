"""The port's C++ triplet augment (vfidkr_torch.data.native, built here with
g++) against the port's Python path (vfidkr_torch.data.vimeo90k
.augment_triplet) and the JAX package's (vfidkr_tpu.data.native
.augment_triplet_batch with its library hidden, as
tests/test_metrics_data_ckpt.py runs it), bit for bit: every combination of
the five records, n = 1 and 5, odd crops and widths, frames of mixed sizes
in one batch, and the thread count.  The library raises, and nothing falls
back, where it cannot be built; it shares PyTorch's OpenMP runtime and
refuses a call from a forked child.  A data-parallel shard of the loader's
batches is tests/test_torch_parallel.py's
test_rank_shards_are_the_global_batch.
"""
import itertools
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vfidkr_tpu.data.native as JN  # noqa: E402

import vfidkr_torch.data.vimeo90k as V  # noqa: E402
from vfidkr_torch.data import native, synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("x0", "x1", "y")


def frames(rng, n, h, w):
    return [rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
            for _ in range(3)]


def native_batch(im1, im2, im3, aug, crop):
    """JAX's entry point's arguments, (N, H, W, 3) stacks and (N, 5)
    records, through the port's augment."""
    return native.augment_triplets(list(zip(im1, im2, im3)), aug, crop)


def draw_records(seed, n, h, w, crop, augment=True):
    rng = np.random.RandomState(seed)
    return np.asarray([V.draw_augment((h, w), augment, rng, crop)
                       for _ in range(n)], np.int32)


def jax_python_path(monkeypatch, im1, im2, im3, aug, crop):
    """JAX's batch, NHWC, by its Python path, as NCHW arrays."""
    monkeypatch.setattr(JN, "load_native", lambda: None)
    out = JN.augment_triplet_batch(im1, im2, im3, np.asarray(aug, np.int32),
                                   crop)
    return {k: out[k].transpose(0, 3, 1, 2) for k in KEYS}


def assert_batches_equal(got, want):
    for k in KEYS:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("swap,oy,ox,lr,ud",
                         list(itertools.product((0, 1), repeat=5)))
def test_every_record_matches_both_python_paths(monkeypatch, swap, oy, ox,
                                                lr, ud):
    """One sample of 40x53 frames cropped to 32x45, its record chosen
    (a 0/1 crop offset picks the origin or the frame's far corner)."""
    h, w, crop = 40, 53, (32, 45)
    rec = (swap, oy * (h - crop[0]), ox * (w - crop[1]), lr, ud)
    im1, im2, im3 = frames(np.random.RandomState(sum(rec)), 1, h, w)
    got = native_batch(im1, im2, im3, [rec], crop)
    assert_batches_equal(got, jax_python_path(monkeypatch, im1, im2, im3,
                                              [rec], crop))
    x0, x1, y = V.apply_augment([im1[0], im2[0], im3[0]], rec, crop)
    assert_batches_equal(got, {k: a.transpose(2, 0, 1)[None]
                               for k, a in zip(KEYS, (x0, x1, y))})


@pytest.mark.parametrize("n,h,w,crop", [(1, 64, 96, (32, 48)),
                                        (5, 64, 96, (32, 48)),
                                        (5, 37, 75, (29, 51)),
                                        (3, 31, 47, (31, 47))])
def test_batches_match_jax(monkeypatch, n, h, w, crop):
    """Records drawn as the loader draws them; odd crops and widths; a crop
    the frame's own size (offsets 0)."""
    im1, im2, im3 = frames(np.random.RandomState(n + h), n, h, w)
    aug = draw_records(1, n, h, w, crop)
    np.testing.assert_array_equal(
        aug, JN.make_aug_records(np.random.RandomState(1), n, h, w, crop,
                                 True))
    got = native_batch(im1, im2, im3, aug, crop)
    assert got["x0"].shape == (n, 3, *crop)
    assert_batches_equal(got, jax_python_path(monkeypatch, im1, im2, im3,
                                              aug, crop))


def test_mixed_frame_sizes_in_one_batch():
    """Samples of two sizes, interleaved: each one equals its Python path;
    frames smaller than the crop take their own size, as a numpy slice
    does, and refuse to share a batch with another size."""
    rng = np.random.RandomState(3)
    sizes = [(40, 48), (36, 52), (40, 48), (36, 52), (36, 52)]
    crop = (32, 40)
    trips = [[rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for _ in range(3)] for h, w in sizes]
    draws = np.random.RandomState(9)
    recs = [V.draw_augment((h, w), True, draws, crop) for h, w in sizes]
    got = native.augment_triplets(trips, recs, crop)
    draws = np.random.RandomState(9)
    for i, trip in enumerate(trips):
        for k, a in zip(KEYS, V.augment_triplet(trip, True, draws, crop)):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          a.transpose(2, 0, 1), err_msg=k)
    small = [[rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
              for _ in range(3)]]
    got = native.augment_triplets(small, [(1, 0, 0, 1, 0)], crop)
    want = V.apply_augment(small[0], (1, 0, 0, 1, 0), crop)
    np.testing.assert_array_equal(got["x0"][0].numpy(),
                                  want[0].transpose(2, 0, 1))
    with pytest.raises(ValueError, match="crop to different sizes"):
        native.augment_triplets(small + trips[:1], [(0,) * 5] * 2, crop)
    with pytest.raises(ValueError, match="leaves the"):
        native.augment_triplets(trips[:1], [(0, 9, 0, 0, 0)], crop)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vimeo")
    synthetic.main(["--out", str(root), "--n", "10", "--height", "40",
                    "--width", "56", "--test-frac", "0.2"])
    return str(root)


def test_thread_count_and_result_independent_of_it(monkeypatch):
    im1, im2, im3 = frames(np.random.RandomState(0), 3, 48, 64)
    aug = draw_records(2, 3, 48, 64, (40, 56))
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    assert native.thread_count() == min(len(os.sched_getaffinity(0)),
                                        native.MAX_THREADS)
    many = native_batch(im1, im2, im3, aug, (40, 56))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert native.thread_count() == 1
    one = native_batch(im1, im2, im3, aug, (40, 56))
    for k in KEYS:
        assert torch.equal(one[k], many[k]), k
    monkeypatch.setenv("OMP_NUM_THREADS", "3,2")
    assert native.thread_count() == 3
    monkeypatch.setenv("OMP_NUM_THREADS", "12")
    assert native.thread_count() == 12


def test_one_openmp_runtime_with_torch():
    """With OMP_NUM_THREADS unset, a process that imports torch and runs the
    augment maps one OpenMP runtime: the library's libgomp.so.1 is the one
    PyTorch loaded."""
    code = ("import numpy as np; from vfidkr_torch.data import native; "
            "im = np.zeros((8, 8, 3), np.uint8); "
            "native.augment_triplets([(im, im, im)], [(0,) * 5], (8, 8)); "
            "print(native.openmp_runtimes())")
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    runtimes = eval(proc.stdout.strip().splitlines()[-1])
    assert len(runtimes) == 1, runtimes


def _call_in_child():
    im = np.zeros((8, 8, 3), np.uint8)
    try:
        native.augment_triplets([(im, im, im)], [(0,) * 5], (8, 8))
    except RuntimeError as e:
        os._exit(0 if "fork-safe" in str(e) else 2)
    os._exit(1)


def test_forked_child_may_not_call():
    """A forked child of the process whose OpenMP pool has run refuses the
    call (libgomp is not fork-safe) instead of entering the pool."""
    im = np.zeros((8, 8, 3), np.uint8)
    native.augment_triplets([(im, im, im)], [(0,) * 5], (8, 8))
    child = multiprocessing.get_context("fork").Process(target=_call_in_child)
    child.start()
    child.join(timeout=60)
    assert not child.is_alive()
    assert child.exitcode == 0


def _unbuilt(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)


def test_missing_compiler_raises_and_nothing_falls_back(monkeypatch,
                                                        tmp_path, tree):
    _unbuilt(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="'g\\+\\+' not found"):
        native.load_library()
    monkeypatch.setenv("CXX", "clang-none")
    with pytest.raises(RuntimeError, match="'clang-none' not found"):
        native.load_library()
    train, _ = V.vimeo90k_splits(tree)
    ds = V.Vimeo90KDataset(tree, train, 2, crop_hw=(32, 40))
    with pytest.raises(RuntimeError, match="not found"):
        next(ds.batches(1))
    assert not (tmp_path / "build").exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    _unbuilt(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed on augment.cpp"):
        native.load_library()
    assert not any((tmp_path / "build").glob("*.so"))


def test_no_libgomp_mapped_raises(monkeypatch, tmp_path):
    """The library links against PyTorch's libgomp and no other: without
    one mapped into the process it raises rather than link a second."""
    _unbuilt(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "openmp_runtimes", lambda: [])
    with pytest.raises(RuntimeError, match="no libgomp is mapped"):
        native.load_library()
    assert not (tmp_path / "build").exists()
