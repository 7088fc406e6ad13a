"""The port's N x video driver (vfidkr_torch.apps.interpolate_video) on the
CPU: against the JAX package's apps/interpolate_video.py (DAIN, t = 0.5,
loaded by path and run in this process) on the same 3-frame 64x64 clip and
the same reference .pth of seeded weights; against the port's own model run
directly (DAIN_slowmotion at t = 0.25, which tests/test_torch_slowmotion.py
holds to JAX, and DAIN's bf16 lane); the video file front and back end; and
the flag errors.

Tolerance against JAX: the same file names and frame counts, the
pass-through frames equal, each synthesised frame within one 8-bit level
of JAX's on at most 0.5 % of its values (float32 sums in another order flip
a rounding now and then).  Against the port's own model: equal.
"""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfidkr_torch.apps import interpolate_video  # noqa: E402
from vfidkr_torch.convert import reference_state_dict  # noqa: E402
from vfidkr_torch.models import DAIN, DAINSlowMotion  # noqa: E402
from vfidkr_torch.utils import pad_to_multiple, unpad  # noqa: E402
from vfidkr_torch.utils.image_io import read_rgb, write_png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, H, W = 3, 64, 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The CPU forwards on two threads: the suite runs as six processes on
    one host, where more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clip_frames():
    """A smooth texture moved 2 px a frame, (H, W, 3) uint8 each."""
    rng = np.random.RandomState(7)
    big = np.kron(rng.rand(12, 16, 3), np.ones((8, 8, 1)))
    return [np.round(big[4:4 + H, 2 * k:2 * k + W] * 255).astype(np.uint8)
            for k in range(N_FRAMES)]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    for k, frame in enumerate(clip_frames(), start=1):
        write_png(root / f"{k:05d}.png", frame)
    return root


def save_weights(model, path):
    torch.save(reference_state_dict(model), path)
    return str(path)


@pytest.fixture(scope="module")
def both_drivers(clip, tmp_path_factory):
    """JAX's driver and the port's, DAIN at t = 0.5 on ``clip``, from one
    .pth: (JAX summary, port summary, JAX out dir, port out dir)."""
    root = tmp_path_factory.mktemp("dain")
    pth = save_weights(DAIN(generator=torch.Generator().manual_seed(0)),
                       root / "dain.pth")
    argv = ["--frames-dir", str(clip), "--time-step", "0.5",
            "--torch-checkpoint", pth]
    spec = importlib.util.spec_from_file_location(
        "jax_interpolate_video", os.path.join(REPO, "apps",
                                              "interpolate_video.py"))
    jax_app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_app)
    mp = pytest.MonkeyPatch()
    mp.setenv("VFIDKR_NO_COMPILE_CACHE", "1")
    mp.setattr("sys.argv", ["interpolate_video.py", *argv, "--out-dir",
                            str(root / "jax")])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jax_app.main()
    finally:
        mp.undo()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got = interpolate_video.main(argv + ["--out-dir", str(root / "port"),
                                         "--device", "cpu"])
    return want, got, root / "jax", root / "port"


def test_same_files_and_counts_as_jax(both_drivers):
    want, got, jax_dir, port_dir = both_drivers
    assert set(got) == set(want)
    for key in ("input_frames", "interpolated_frames", "fps_in", "fps_out"):
        assert got[key] == want[key], key
    assert got["input_frames"] == N_FRAMES
    assert got["interpolated_frames"] == N_FRAMES - 1
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    assert names == sorted([f"{k:05d}000.png" for k in range(1, 4)]
                           + [f"{k:05d}001.png" for k in range(1, 3)])


def test_pass_through_frames_equal_jax_and_the_input(both_drivers):
    _, _, jax_dir, port_dir = both_drivers
    for k, frame in enumerate(clip_frames(), start=1):
        got = read_rgb(port_dir / f"{k:05d}000.png")
        np.testing.assert_array_equal(got, frame)
        np.testing.assert_array_equal(
            got, read_rgb(jax_dir / f"{k:05d}000.png"))


def test_synthesised_frames_within_one_level_of_jax(both_drivers):
    _, _, jax_dir, port_dir = both_drivers
    for k in (1, 2):
        got = read_rgb(port_dir / f"{k:05d}001.png").astype(int)
        want = read_rgb(jax_dir / f"{k:05d}001.png").astype(int)
        diff = np.abs(got - want)
        assert diff.max() <= 1, (k, diff.max())
        assert (diff > 0).mean() <= 0.005, (k, (diff > 0).mean())


@pytest.mark.parametrize("net,t,dtype", [
    ("DAIN_slowmotion", 0.25, "float32"), ("DAIN", 0.5, "bfloat16")])
def test_driver_writes_the_models_frames(clip, tmp_path, net, t, dtype):
    """Each synthesised frame is round(clip(unpad(forward))) of the model
    on the padded pair, and the offsets run 1..1/t-1."""
    gen = torch.Generator().manual_seed(1)
    model = (DAINSlowMotion(t, generator=gen) if net == "DAIN_slowmotion"
             else DAIN(generator=gen))
    pth = save_weights(model, tmp_path / "w.pth")
    if dtype == "bfloat16":
        twin = DAIN(compute_dtype="bfloat16")
        twin.load_state_dict(model.state_dict())
        model = twin
    model.eval()
    out_dir = tmp_path / "out"
    summary = interpolate_video.main([
        "--frames-dir", str(clip), "--out-dir", str(out_dir), "--model", net,
        "--time-step", str(t), "--compute-dtype", dtype,
        "--torch-checkpoint", pth, "--device", "cpu"])
    k = round(1 / t) - 1
    assert summary["interpolated_frames"] == k * (N_FRAMES - 1)
    assert sorted(os.listdir(out_dir)) == sorted(
        [f"{i:05d}000.png" for i in range(1, N_FRAMES + 1)]
        + [f"{i:05d}{j:03d}.png" for i in range(1, N_FRAMES)
           for j in range(1, k + 1)])
    frames = clip_frames()
    to = lambda f: torch.from_numpy(f).permute(2, 0, 1)[None].float() / 255
    for i in range(1, N_FRAMES):
        a, pads = pad_to_multiple(to(frames[i - 1]))
        b, _ = pad_to_multiple(to(frames[i]))
        assert tuple(a.shape[2:]) == (128, 128)
        with torch.inference_mode():
            outs = model(a, b)["outputs"][1]
        outs = outs if isinstance(outs, list) else [outs]
        for j, o in enumerate(outs, start=1):
            want = torch.round(unpad(o, pads).clamp(0, 1) * 255)[0]
            np.testing.assert_array_equal(
                read_rgb(out_dir / f"{i:05d}{j:03d}.png"),
                want.permute(1, 2, 0).to(torch.uint8).numpy())


def test_video_in_and_video_out(tmp_path):
    cv2 = pytest.importorskip("cv2")
    clip_path = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(clip_path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (W, H))
    assert writer.isOpened()
    for frame in clip_frames():
        writer.write(frame[:, :, ::-1])
    writer.release()
    out_mp4 = str(tmp_path / "out.mp4")
    summary = interpolate_video.main([
        "--video-in", clip_path, "--video-out", out_mp4, "--out-dir",
        str(tmp_path / "frames"), "--device", "cpu"])
    assert summary["input_frames"] == N_FRAMES
    assert summary["fps_in"] == pytest.approx(10.0)
    assert summary["fps_out"] == pytest.approx(20.0)
    cap = cv2.VideoCapture(out_mp4)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 2 * N_FRAMES - 1
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(20.0)
    cap.release()
    assert len(os.listdir(tmp_path / "frames")) == 2 * N_FRAMES - 1


@pytest.mark.parametrize("case,match", [
    ("dain_t", "time-step 0.5 only"), ("no_input", "exactly one input"),
    ("two_inputs", "exactly one input"), ("no_output", "at least one output"),
    ("one_frame", "at least two frames")])
def test_flag_errors(clip, tmp_path, capsys, case, match):
    one = tmp_path / "one"
    one.mkdir()
    write_png(one / "00001.png", clip_frames()[0])
    argv = {"dain_t": ["--frames-dir", str(clip), "--out-dir", "o",
                       "--time-step", "0.25"],
            "no_input": ["--out-dir", "o"],
            "two_inputs": ["--frames-dir", str(clip), "--video-in", "x.mp4",
                           "--out-dir", "o"],
            "no_output": ["--frames-dir", str(clip)],
            "one_frame": ["--frames-dir", str(one), "--out-dir", "o"]}[case]
    with pytest.raises(SystemExit) as err:
        interpolate_video.main(argv + ["--device", "cpu"])
    assert err.value.code == 2
    assert match in capsys.readouterr().err


def test_driver_defaults_to_the_card():
    args = interpolate_video.build_parser().parse_args(["--frames-dir", "x"])
    assert args.device == "cuda" and args.save_which == -1
    assert args.compute_dtype == "float32" and args.model == "DAIN"
