"""The port's depth evaluation (vfidkr_torch.utils.depth_eval and
vfidkr_torch.apps.depth_eval) against the JAX package's on the CPU: the two
metrics on the same numpy arrays (si-RMSE to rtol 1e-5, float32 sums in
another order; the SDR counts equal), ``load_sample`` against
apps/depth_eval.py's (loaded by path; it imports JAX only inside ``main``)
bit for bit, and the port's driver end to end, its result against JAX's
metric functions applied to the port's MegaDepth output, with each kind of
checkpoint it reads.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from vfidkr_tpu.utils import depth_eval as jax_metrics  # noqa: E402

from vfidkr_torch.apps import depth_eval  # noqa: E402
from vfidkr_torch.models.megadepth import MegaDepthHourglass  # noqa: E402
from vfidkr_torch.utils import depth_eval as metrics  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, PAIRS = 64, 96, 50


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_invariant_rmse_matches_jax(seed):
    rng = np.random.RandomState(seed)
    lp, lg = (rng.randn(24, 32).astype(np.float32) for _ in range(2))
    mask = (rng.rand(24, 32) > 0.3).astype(np.float32)
    got = metrics.scale_invariant_rmse(*map(torch.from_numpy, (lp, lg, mask)))
    want = jax_metrics.scale_invariant_rmse(*map(jnp.asarray, (lp, lg, mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sdr_counts_match_jax(seed):
    rng = np.random.RandomState(seed)
    h, w, p = 10, 14, 200
    log_pred = (rng.randn(h, w) * 0.3).astype(np.float32)
    pairs = [rng.randint(0, n, p) for n in (w, h, w, h)] + [
        rng.randint(-1, 2, p)]
    errs, counts = metrics.sdr_counts(torch.from_numpy(log_pred),
                                      *map(torch.from_numpy, pairs))
    want_e, want_n = jax_metrics.sdr_counts(
        jnp.asarray(log_pred), *(jnp.asarray(a, jnp.int32) for a in pairs))
    assert errs.tolist() == np.asarray(want_e).tolist()
    assert counts.tolist() == np.asarray(want_n).tolist()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Two samples a little larger than the eval size (so both are
    resized): an RGB image with SDR pairs, a gray one without; depths with
    an invalid band."""
    root = tmp_path_factory.mktemp("md")
    rng = np.random.RandomState(0)
    for i in range(2):
        img = np.kron(rng.rand(10, 13, 3), np.ones((8, 8, 1)))[:H + 8, :W + 8]
        img = (img * 255).astype(np.uint8)
        Image.fromarray(img if i == 0 else img[..., 0]).save(root / f"s{i}.png")
        depth = (rng.rand(H + 8, W + 8) * 10 + 0.5).astype(np.float32)
        depth[:4] = 0.0
        with h5py.File(root / f"s{i}.h5", "w") as f:
            f.create_dataset("/depth", data=depth)
    np.savez(root / "s0.sdr.npz", xA=rng.randint(0, W, PAIRS),
             yA=rng.randint(0, H, PAIRS), xB=rng.randint(0, W, PAIRS),
             yB=rng.randint(0, H, PAIRS), gt=rng.randint(-1, 2, PAIRS))
    return root


def _jax_app():
    spec = importlib.util.spec_from_file_location(
        "jax_depth_eval", os.path.join(REPO, "apps", "depth_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i", [0, 1])
def test_load_sample_matches_jax(data_root, i):
    args = (str(data_root / f"s{i}.png"), str(data_root / f"s{i}.h5"), (H, W))
    got = depth_eval.load_sample(*args)
    want = _jax_app().load_sample(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("checkpoint", [None, "bare", "dain_slowmotion"])
def test_driver_end_to_end(data_root, tmp_path, capsys, checkpoint):
    """The result against JAX's metric functions on the port's MegaDepth
    output: seed 0's weights without a checkpoint, seed 1's through a bare
    ``module.``-prefixed .pth or a DAIN_slowmotion state dict."""
    argv = ["--data-root", str(data_root), "--input-height", str(H),
            "--input-width", str(W), "--device", "cpu"]
    model = MegaDepthHourglass(generator=torch.Generator().manual_seed(
        0 if checkpoint is None else 1)).eval()
    if checkpoint:
        sd = model.state_dict()
        sd = ({f"module.{k}": v for k, v in sd.items()} if checkpoint == "bare"
              else {**{f"depthNet.{k}": v for k, v in sd.items()},
                    "flownets.conv1a.0.weight": torch.zeros(16, 3, 3, 3)})
        torch.save(sd, tmp_path / "ck.pth")
        argv += ["--torch-checkpoint", str(tmp_path / "ck.pth")]
    result = depth_eval.main(argv)
    assert result["images"] == 2 and result["rmse_images"] == 2

    rmse, err, n = [], np.zeros(3, np.int64), np.zeros(3, np.int64)
    for i in range(2):
        img, gt, mask = depth_eval.load_sample(
            str(data_root / f"s{i}.png"), str(data_root / f"s{i}.h5"), (H, W))
        with torch.inference_mode():
            log_pred = model(torch.from_numpy(img.transpose(2, 0, 1).copy())
                             [None])[0, 0].numpy()
        rmse.append(float(jax_metrics.scale_invariant_rmse(
            jnp.asarray(log_pred), jnp.log(jnp.asarray(gt)),
            jnp.asarray(mask))))
        if i == 0:
            with np.load(data_root / "s0.sdr.npz") as z:
                e, c = jax_metrics.sdr_counts(
                    jnp.asarray(log_pred), *(jnp.asarray(z[k], jnp.int32)
                                             for k in depth_eval.SDR_KEYS))
            err, n = np.asarray(e), np.asarray(c)
    assert result["si_rmse"] == pytest.approx(np.mean(rmse), rel=1e-5)
    assert result["sdr"] == {"equal": err[0] / max(n[0], 1),
                             "unequal": err[1] / max(n[1], 1),
                             "total": err[2] / n[2], "pairs": PAIRS}


def test_driver_without_samples(tmp_path, capsys):
    result = depth_eval.main(["--data-root", str(tmp_path), "--device", "cpu"])
    assert "error" in result
    assert depth_eval.parse_args(["--data-root", "x"]).device == "cuda"
