"""SoftSplat in the port (``models/softsplat.py``) and its splat
(``ops.softsplat.softmax_splat``, the kernel K12 on the card).

On the CPU: the network at its published widths against the benchmark's
plain reference (``benchmark/reference/softsplat.py``) on seeded weights;
the plain splat against a float64 scatter; the backward warp's sample
points; the spans' partition of the forward; the registry, the time-step
rule and the video driver on SoftSplat.  On the card only (marker
``cuda``; no JAX is imported here):

    python -m pytest --noconftest -m cuda tests/test_torch_softsplat.py -q

K12 against the plain version in float64 at the 1080p cell's three levels
and at a ragged size, a jump that takes its direct adds, and one
forward's launches.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib.cell import load_json  # noqa: E402
from benchmark.lib.weights import make_state, shapes_of  # noqa: E402
from benchmark.reference import softsplat as ref  # noqa: E402
from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.config import NET_NAMES, ModelConfig  # noqa: E402
from vfidkr_torch.models import MODEL_REGISTRY, SoftSplat  # noqa: E402
from vfidkr_torch.ops import softsplat as SS  # noqa: E402
from vfidkr_torch.ops.warp import backwarp  # noqa: E402
from torch_splat import float64_splat, level_inputs  # noqa: E402

CONFIG = load_json(Path(__file__).resolve().parents[1] / "benchmark" /
                   "configs" / "softsplat.json")
SEED = 2 ** 31 + 23
SPANS = ("vfidkr/flow", "vfidkr/upsample", "vfidkr/softsplat/metric",
         "vfidkr/softsplat/pyramid", "vfidkr/softsplat/splat",
         "vfidkr/softsplat/synthesis")


def _weights(seed=SEED):
    with torch.device("meta"):
        meta = ModelConfig("SoftSplat").build()
    return make_state(shapes_of(meta), CONFIG, seed, "cpu")


def _model(seed=SEED):
    model = SoftSplat().eval()
    model.load_state_dict(_weights(seed), strict=True)
    return model


def _frames(g, n, h, w, shift=(0, 0)):
    """A smooth random scene and the same scene moved by ``shift`` (dy,
    dx) px."""
    coarse = torch.rand(n, 3, h // 16 + 1, w // 16 + 1, generator=g)
    a = torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bicubic", align_corners=False).clamp(0, 1)
    return a, torch.roll(a, shift, (2, 3))


def test_program_matches_the_reference_at_published_widths():
    """2 x 3 x 128 x 192 on seeded weights.  Tolerance 2e-6 absolute on
    outputs near 0.5 that the network moves by about 3 levels (1.2e-2):
    both are float32 on the CPU, with the splat's sums, the backward warp's
    taps and the batching of the convs (the program runs both frames and
    both pairs as one batch) in other orders."""
    state = _weights()
    model = SoftSplat().eval()
    model.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in model.parameters()) == \
        CONFIG["trained_elements"]
    g = torch.Generator().manual_seed(3)
    i0, i2 = _frames(g, 2, 128, 192, (-3, 5))
    with torch.no_grad():
        got = model(i0, i2)["outputs"]
        want = ref.softsplat(state, i0, i2, CONFIG["lanes"]["float32"],
                             CONFIG)[0]
    assert len(got) == len(want) == 1 and got[0].shape == (2, 3, 128, 192)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    # the tamed weights keep the frame inside [0, 1] and the network alive
    assert 0.0 < float(want[0].min()) and float(want[0].max()) < 1.0
    spread = float(want[0].std((2, 3)).mean()) * 255
    assert 0.5 < spread < 10.0, spread


def _splat64(x, flow, z):
    """The splat in float64 by a loop over the source pixels and their four
    corners; also the magnitude ``sum w e^z |x| / (sum w e^z + 1e-7)``.
    The landing ``x + fx`` is rounded to float32 first, as every float32
    splat rounds it: a weight near 0 is then the same small number in
    both."""
    q = (torch.stack(torch.meshgrid(torch.arange(x.shape[3]),
                                    torch.arange(x.shape[2]),
                                    indexing="xy"), 0).float()
         + flow).double().numpy()
    x, flow, z = (t.double().numpy() for t in (x, flow, z))
    n, c, h, w = x.shape
    num, mag = np.zeros((n, c, h, w)), np.zeros((n, c, h, w))
    den = np.zeros((n, 1, h, w))
    for b in range(n):
        for y in range(h):
            for xx in range(w):
                qx, qy = q[b, 0, y, xx], q[b, 1, y, xx]
                if not (math.isfinite(qx) and math.isfinite(qy)):
                    continue
                e = math.exp(z[b, 0, y, xx])
                for cy in (math.floor(qy), math.floor(qy) + 1):
                    for cx in (math.floor(qx), math.floor(qx) + 1):
                        if not (0 <= cx < w and 0 <= cy < h):
                            continue
                        wgt = (1 - abs(qx - cx)) * (1 - abs(qy - cy)) * e
                        num[b, :, cy, cx] += wgt * x[b, :, y, xx]
                        mag[b, :, cy, cx] += wgt * abs(x[b, :, y, xx])
                        den[b, 0, cy, cx] += wgt
    return num / (den + SS.EPS), mag / (den + SS.EPS)


def _splat_case(name, n=2, c=5, h=9, w=13, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, c, h, w, generator=g) * 2 - 1
    flow = (torch.rand(n, 2, h, w, generator=g) * 2 - 1) * 2.5
    z = (torch.rand(n, 1, h, w, generator=g) * 2 - 1) * 3
    if name == "off_frame":
        flow[:, 0, :, -3:] += 2.7           # past the right edge
        flow[:, 1, :2] -= 1.6               # above the top
        flow[:, 0, :, 0] = -0.5             # half a corner off the left
    elif name == "non_finite":
        flow[0, 0, 1, 2] = float("nan")
        flow[1, 1, 3, 4] = float("inf")
        flow[0, 1, 5, 6] = -float("inf")
    elif name == "converge":                # every source on one cell
        ys = torch.arange(h, dtype=torch.float32).view(h, 1)
        xs = torch.arange(w, dtype=torch.float32)
        flow[:, 0] = 6.3 - xs
        flow[:, 1] = 4.6 - ys
    elif name == "z_extremes":
        z[0] = -20.0
        z[1] = 0.0
        z[1, 0, ::2] = -20.0
    elif name == "both_directions":         # opposite moves, as the model
        flow[1] = -flow[0]
    return x, flow, z


@pytest.mark.parametrize("name", ["off_frame", "non_finite", "converge",
                                  "z_extremes", "both_directions"])
def test_plain_splat_against_a_float64_scatter(name):
    """Error over ``sum w e^z |x| / (sum w e^z + 1e-7) + |out|``, 1e-5:
    float32 terms and sums in another order, up to 117 terms a cell where
    every source converges on one (n 2^-24 = 7e-6)."""
    x, flow, z = _splat_case(name)
    got = SS.softmax_splat_plain(x, flow, z).double().numpy()
    want, mag = _splat64(x, flow, z)
    err = np.abs(got - want)
    assert (err <= 1e-5 * (mag + np.abs(want)) + 1e-30).all(), \
        float((err / (mag + np.abs(want) + 1e-30)).max())
    # the wrapper takes the plain version on the CPU and launches nothing
    assert torch.equal(SS.softmax_splat(x, flow, z),
                       SS.softmax_splat_plain(x, flow, z))
    assert kernels.LAUNCHES["softmax_splat"] == 0
    if name == "converge":      # one cell holds the weighted mean of all
        assert np.count_nonzero(np.abs(want).sum(1) > 0) == 2 * 4


def test_splat_refuses_what_it_does_not_take():
    x, flow, z = _splat_case("both_directions")
    with pytest.raises(ValueError, match="flow"):
        SS.softmax_splat(x, flow[:, :1], z)
    with pytest.raises(ValueError, match="z"):
        SS.softmax_splat(x, flow, z[:1])
    with pytest.raises(TypeError, match="float32"):
        SS.softmax_splat(x.double(), flow.double(), z.double())


def test_backwarp_samples_at_exactly_x_plus_flow():
    """On a linear ramp the bilinear sample is the ramp's value at x + F
    wherever all four taps lie inside; a whole shift moves the frame with
    zeros behind it; a sample a whole pixel outside reads 0."""
    h, w = 11, 17
    ys = torch.arange(h, dtype=torch.float32).view(1, 1, h, 1)
    xs = torch.arange(w, dtype=torch.float32).view(1, 1, 1, w)
    ramp = (0.25 * xs + 0.5 * ys + 1.0).expand(1, 2, h, w).contiguous()
    g = torch.Generator().manual_seed(1)
    flow = torch.rand(1, 2, h, w, generator=g) * 3 - 1.5
    got = backwarp(ramp, flow)
    qx, qy = xs + flow[:, :1], ys + flow[:, 1:]
    inside = (qx >= 0) & (qx <= w - 1) & (qy >= 0) & (qy <= h - 1)
    want = 0.25 * qx + 0.5 * qy + 1.0
    assert bool(inside.sum() > 50)
    torch.testing.assert_close(got[:, :1][inside], want[inside], rtol=0,
                               atol=1e-5)
    shift = torch.zeros(1, 2, h, w)
    shift[:, 0], shift[:, 1] = 2.0, -1.0
    moved = backwarp(ramp, shift)
    assert torch.equal(moved[..., 1:, :w - 2], ramp[..., :h - 1, 2:])
    assert not moved[..., :, w - 2:].any() and not moved[..., :1, :].any()
    far = torch.full((1, 2, h, w), float(w))
    assert not backwarp(ramp, far).any()


def test_every_forward_op_lies_in_exactly_one_span():
    """``vfidkr/flow``, ``vfidkr/upsample`` and the four
    ``vfidkr/softsplat/*`` spans, once each inside ``vfidkr/forward``, hold
    every ATen op of the forward, so the per-layer metrics that read them
    add up to the forward."""
    from torch.autograd import DeviceType
    model = _model()
    g = torch.Generator().manual_seed(1)
    i0, i2 = _frames(g, 1, 64, 64, (1, -2))
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(i0, i2)
    ev = [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CPU]
    inside = lambda e, o: (e[2] == o[2] and o[0] <= e[0] and e[1] <= o[1])
    (fwd,) = [e for e in ev if e[3] == "vfidkr/forward"]
    stages = [e for e in ev if e[3] in SPANS]
    assert sorted(e[3] for e in stages) == sorted(SPANS)
    assert all(inside(s, fwd) for s in stages)
    ops = [e for e in ev if e[3].startswith("aten::") and inside(e, fwd)]
    assert len(ops) > 100
    for op in ops:
        assert sum(inside(op, s) for s in stages) == 1, op


def test_registry_config_and_time_step():
    assert MODEL_REGISTRY["SoftSplat"] is SoftSplat
    assert "SoftSplat" in NET_NAMES
    assert isinstance(ModelConfig(net_name="SoftSplat").build(), SoftSplat)
    with pytest.raises(ValueError, match="t = 0.5"):
        ModelConfig(net_name="SoftSplat", time_step=0.25)
    with pytest.raises(ValueError, match="float32"):
        SoftSplat(compute_dtype="bfloat16")


def test_frames_between_on_softsplat_gives_one_uint8_frame():
    """The driver's defaults pick SoftSplat's one output: the flag's and
    the function's (``EvalConfig.save_which``)."""
    from vfidkr_torch.apps.interpolate_video import (build_parser,
                                                     frames_between, to_input)
    model = _model()
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (70, 100, 3), dtype=np.uint8)
            for _ in range(2))
    a_in, pads = to_input(a, "cpu")
    b_in, _ = to_input(b, "cpu")
    args = build_parser().parse_args(["--frames-dir", "f", "--model",
                                      "SoftSplat"])
    out = frames_between(model, a_in, b_in, pads, args.save_which)
    assert out.shape == (1, 70, 100, 3) and out.dtype == torch.uint8
    assert torch.equal(frames_between(model, a_in, b_in, pads), out)


def test_video_driver_runs_softsplat(tmp_path):
    """``apps/interpolate_video.py --model SoftSplat`` on two 64 x 96 PNG
    frames: both passed through and one frame synthesised between them."""
    from vfidkr_torch.apps.interpolate_video import main
    from vfidkr_torch.utils.image_io import read_png, write_png
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        write_png(str(src / f"{i:03d}.png"),
                  rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    summary = main(["--frames-dir", str(src), "--out-dir", str(out),
                    "--model", "SoftSplat", "--device", "cpu"])
    assert summary["interpolated_frames"] == 1
    names = sorted(p.name for p in out.iterdir())
    assert names == ["00001000.png", "00001001.png", "00002000.png"]
    assert read_png(str(out / "00001001.png")).shape == (64, 96, 3)


# -- on the card --------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close_to_float64(got, x, flow, z):
    """Error over the float64 magnitude (``torch_splat.float64_splat``),
    1e-5: float32 terms and atomic sums in any order."""
    want, scale = float64_splat(x, flow, z)
    err = (got.double() - want).abs()
    bad = err > 1e-5 * scale
    assert not bool(bad.any()), float((err / (scale + 1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(2, 35, 1152, 1984), (2, 64, 576, 992),
                                     (2, 96, 288, 496), (2, 35, 37, 75)])
def test_k12_against_the_plain_version(dev, n, c, h, w):
    """K12 at the 1080p cell's three levels (both directions) and a ragged
    frame that no tile divides: one launch a call, no direct tiles on the
    near-uniform move."""
    x, flow, z = level_inputs(n, c, h, w, dev)
    before = kernels.LAUNCHES["softmax_splat"]
    with torch.inference_mode():
        got, direct = SS.softmax_splat_counted(x, flow, z)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["softmax_splat"] == before + 1
    assert direct == 0
    _close_to_float64(got, x, flow, z)


@pytest.mark.cuda
def test_k12_takes_direct_adds_across_a_jump(dev):
    x, flow, z = level_inputs(2, 35, 96, 512, dev, jump=True)
    with torch.inference_mode():
        got, direct = SS.softmax_splat_counted(x, flow, z)
    torch.cuda.synchronize()
    assert direct > 0
    _close_to_float64(got, x, flow, z)


@pytest.mark.cuda
def test_k12_refuses_a_gradient(dev):
    x, flow, z = level_inputs(1, 3, 8, 8, dev)
    with pytest.raises(RuntimeError, match="no backward"):
        SS.softmax_splat(x.requires_grad_(), flow, z)


@pytest.mark.cuda
def test_softsplat_forward_launches_k12_three_times(dev):
    """One forward at 128 x 192: K12 once a level (two kernels each), K10
    25, K11 and K13 5 times in PWC-Net, nothing else of the port; the frame
    against the CPU's within 1e-4 (cuDNN's float32 convs and K12's atomic
    sums in other orders, carried through the GridNet)."""
    model = _model()
    g = torch.Generator().manual_seed(2)
    i0, i2 = _frames(g, 1, 128, 192, (-3, 5))
    with torch.inference_mode():
        want = model(i0, i2)["outputs"][0]
    gpu = model.to(dev)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = gpu(i0.to(dev), i2.to(dev))["outputs"][0]
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"softmax_splat": 3, "dense_conv": 25, "flow_head": 5,
                        "correlation": 5}
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
