"""The port's eval apps and their helpers, on the CPU: replication
padding and the metrics against ``vfidkr_tpu.utils`` on the same arrays
(padding exactly; metrics to rtol 1e-5, float32 sums in another order), the
model flags, and both apps end to end on tiny synthetic data (PNGs
written with PIL), their results equal to the model and metrics run
directly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from vfidkr_tpu.utils import metrics as jax_metrics  # noqa: E402
from vfidkr_tpu.utils import padding as jax_padding  # noqa: E402

from vfidkr_torch.apps import demo_middlebury, eval_vimeo  # noqa: E402
from vfidkr_torch.apps import train as train_app  # noqa: E402
from vfidkr_torch.config import ModelConfig, add_model_flags  # noqa: E402
from vfidkr_torch.models import DAIN, DAINSlowMotion  # noqa: E402
from vfidkr_torch.utils import (interpolation_error, pad_to_multiple,  # noqa: E402
                                psnr, psnr_per_image, ssim, ssim_per_image,
                                unpad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The apps' CPU forwards on two threads: the suite runs as six
    processes on one host, where more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("h,w", [(256, 448), (480, 640), (37, 75)])
def test_pad_to_multiple_matches_jax(rng, h, w):
    x = rng.rand(2, h, w, 3).astype(np.float32)
    want, want_pads = jax_padding.pad_to_multiple(jnp.asarray(x))
    got, pads = pad_to_multiple(nchw(x))
    assert pads == tuple(want_pads)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    assert got.shape[2] % 64 == 0 and got.shape[3] % 64 == 0
    assert torch.equal(unpad(got, pads), nchw(x))


@pytest.fixture
def frame_pairs(rng):
    """A prediction and a ground truth, two [0, 255] images each on the
    8-bit grid, NHWC."""
    gt = np.round(rng.rand(2, 24, 30, 3) * 255).astype(np.float32)
    pred = np.clip(gt + np.round(rng.randn(*gt.shape) * 12), 0, 255)
    return pred.astype(np.float32), gt


@pytest.mark.parametrize("name", ["interpolation_error", "psnr",
                                  "psnr_per_image", "ssim_per_image", "ssim",
                                  "psnr_one_image"])
def test_metrics_match_jax(frame_pairs, name):
    pred, gt = frame_pairs
    fns = {"interpolation_error": (interpolation_error, 255.0),
           "psnr": (psnr, 255.0), "psnr_per_image": (psnr_per_image, 255.0),
           "ssim_per_image": (ssim_per_image, 1.0), "ssim": (ssim, 1.0)}
    if name == "psnr_one_image":
        got = psnr(nchw(pred)[0], nchw(gt)[0])
        want = jax_metrics.psnr(jnp.asarray(pred[0]), jnp.asarray(gt[0]))
    else:
        fn, scale = fns[name]
        got = fn(nchw(pred) / (255.0 / scale), nchw(gt) / (255.0 / scale))
        want = getattr(jax_metrics, name)(jnp.asarray(pred) / (255.0 / scale),
                                          jnp.asarray(gt) / (255.0 / scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _parse(argv, **defaults):
    import argparse
    ap = argparse.ArgumentParser()
    add_model_flags(ap, **defaults)
    return ap.parse_args(argv)


def test_model_config_round_trips_the_flags():
    args = _parse(["--net-name", "DAIN_slowmotion", "--time-step", "0.25",
                   "--compute-dtype", "bfloat16"], net_name="DAIN",
                  time_step=0.5)
    cfg = ModelConfig.from_args(args)
    assert cfg == ModelConfig("DAIN_slowmotion", 0.25, "bfloat16")
    model = cfg.build()
    assert isinstance(model, DAINSlowMotion) and model.num_frames == 3
    assert model.rectifyNet.compute_dtype == torch.bfloat16
    # apps that pin the model register no --net-name; overrides win
    args = _parse([])
    assert not hasattr(args, "net_name") and args.compute_dtype == "float32"
    cfg = ModelConfig.from_args(args, net_name="DAIN")
    assert cfg == ModelConfig() and isinstance(cfg.build(), DAIN)
    with pytest.raises(ValueError, match="t = 0.5"):
        ModelConfig("DAIN", 0.25).build()
    with pytest.raises(ValueError, match="net_name"):
        ModelConfig("SepConv").build()


def test_apps_default_to_the_card():
    assert demo_middlebury.parse_args(["--root", "x"]).device == "cuda"
    assert eval_vimeo.parse_args(["--dataset-path", "x"]).device == "cuda"
    assert eval_vimeo.parse_args(["--dataset-path", "x"]).batch_size == 1
    assert train_app.parse_args(["--dataset-path", "x", "--save-path",
                                 "y"]).device == "cuda"


def _seeded_dain(compute_dtype, seed=0):
    return DAIN(generator=torch.Generator().manual_seed(seed),
                compute_dtype=compute_dtype).eval()


@pytest.fixture(scope="module")
def middlebury_root(tmp_path_factory):
    """Two sequences of 64x96 frames (padded to 128x128): a smooth texture
    moved by 2 px a frame."""
    root = tmp_path_factory.mktemp("middlebury")
    rng = np.random.RandomState(5)
    for seq in ("seq0", "seq1"):
        big = np.kron(rng.rand(12, 16, 3), np.ones((8, 8, 1)))
        os.makedirs(root / seq)
        for k, name in enumerate(("im2.png", "im3.png", "im4.png")):
            frame = big[4:68, 2 * k:2 * k + 96]
            Image.fromarray(np.round(frame * 255).astype(np.uint8)).save(
                root / seq / name)
    return root


@pytest.mark.parametrize("compute_dtype,checkpoint",
                         [("float32", False), ("bfloat16", True)])
def test_middlebury_app_end_to_end(middlebury_root, tmp_path, capsys,
                                      compute_dtype, checkpoint):
    """Without a checkpoint the weights are seed 0's; with one, a reference
    .pth's (under ``state_dict``, ``module.``-prefixed, with a key DAIN
    does not have)."""
    out_dir = tmp_path / "out"
    argv = ["--root", str(middlebury_root), "--out-dir", str(out_dir),
            "--device", "cpu", "--compute-dtype", compute_dtype]
    model = _seeded_dain(compute_dtype, seed=1 if checkpoint else 0)
    if checkpoint:
        sd = {f"module.{k}": v for k, v in model.state_dict().items()}
        sd["module.initOcclusion.conv.weight"] = torch.zeros(3)
        torch.save({"state_dict": sd}, tmp_path / "ref.pth")
        argv += ["--torch-checkpoint", str(tmp_path / "ref.pth")]
    summary = demo_middlebury.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == summary
    assert summary["sequences"] == 2
    assert summary["device_time_per_pair_s"] is None

    ies, psnrs, ssims = [], [], []
    for seq in ("seq0", "seq1"):
        x0, gt, x1 = (nchw(np.asarray(Image.open(
            middlebury_root / seq / n), np.float32)[None] / 255.0)
            for n in ("im2.png", "im3.png", "im4.png"))
        x0p, pads = pad_to_multiple(x0)
        assert tuple(x0p.shape) == (1, 3, 128, 128)
        with torch.inference_mode():
            out = model(x0p, pad_to_multiple(x1)[0])["outputs"][1]
        out = unpad(out, pads).clamp(0, 1)
        out255, gt255 = torch.round(out * 255), torch.round(gt * 255)
        ies.append(float(interpolation_error(out255, gt255)))
        psnrs.append(float(psnr(out255, gt255)))
        ssims.append(float(ssim(out, gt)))
        saved = np.asarray(Image.open(out_dir / seq / "im3.png"))
        np.testing.assert_array_equal(
            saved, out255[0].permute(1, 2, 0).to(torch.uint8).numpy())
    assert summary["avg_ie"] == pytest.approx(np.mean(ies), rel=1e-6)
    assert summary["avg_psnr"] == pytest.approx(np.mean(psnrs), rel=1e-6)
    assert summary["avg_ssim"] == pytest.approx(np.mean(ssims), rel=1e-6)


def test_middlebury_core_refuses_to_time_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        demo_middlebury.evaluate(_seeded_dain("float32"), [], "cpu",
                                 measure_time=True)


def test_vimeo_app_end_to_end(tmp_path, capsys):
    """Three test pairs at batch 2: one full batch and a remainder of one,
    padded by repeating the last pair; the metrics are the per-pair ones."""
    data = tmp_path / "vimeo"
    subprocess.run([sys.executable, "tools/make_synthetic_vimeo.py",
                    "--out", str(data), "--n", "5", "--height", "64",
                    "--width", "64", "--test-frac", "0.6"],
                   cwd=REPO, check=True, capture_output=True, timeout=120)
    result = eval_vimeo.main(["--dataset-path", str(data), "--device", "cpu",
                              "--batch-size", "2", "--out-dir",
                              str(tmp_path / "out")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == result

    from vfidkr_torch.data.vimeo90k import vimeo90k_splits
    _, test_paths = vimeo90k_splits(str(data))
    assert result["pairs"] == len(test_paths) == 3
    model = _seeded_dain("float32")
    psnrs, ssims, ies = [], [], []
    for rel in test_paths:
        seq = data / "sequences" / rel
        x0, y, x1 = (nchw(np.asarray(Image.open(seq / n), np.float32)[None]
                          / 255.0) for n in ("im1.png", "im2.png", "im3.png"))
        p, s, e, frame = eval_vimeo.eval_step(model, x0, x1, y)
        psnrs.append(float(p[0]))
        ssims.append(float(s[0]))
        ies.append(float(e[0]))
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "out" / rel / "output-im2.png")),
            frame[0].numpy())
    assert result["avg_psnr"] == pytest.approx(np.mean(psnrs), rel=1e-6)
    assert result["avg_ssim"] == pytest.approx(np.mean(ssims), rel=1e-6)
    assert result["avg_ie"] == pytest.approx(np.mean(ies), rel=1e-6)
