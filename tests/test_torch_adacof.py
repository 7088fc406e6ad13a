"""AdaCoF+ in the port (``models/adacof.py``), its sampling
(``ops.adacof.adacof_pair``, the kernel K14 on the card) and the U-Net it
shares with SepConv (``models/unet.py``).

On the CPU: the network against the benchmark's plain reference
(``benchmark/reference/adacof.py``) on seeded weights, at AdaCoF+'s (F, D)
= (11, 2) and AdaCoF's (5, 1), B = 1 and 2; the plain sampling against the
reference's and against a float64 sample at the clamped position, where
floor and truncation part, past the pad on every side and at D = 2; the
parameter counts; SepConv's keys, output, ops and spans through the shared
U-Net; the spans; the registry, the time-step rule and the video driver.
K14 itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, marker ``cuda``).
"""

import copy
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib.cell import load_json  # noqa: E402
from benchmark.lib.weights import make_state, shapes_of  # noqa: E402
from benchmark.reference import adacof as ref  # noqa: E402
from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.config import NET_NAMES, ModelConfig  # noqa: E402
from vfidkr_torch.models import (MODEL_REGISTRY, AdaCoFPlus,  # noqa: E402
                                 SepConv)
from vfidkr_torch.models.layers import avg_pool_2x2  # noqa: E402
# the module (its function of the same name is what callers use)
AC = importlib.import_module("vfidkr_torch.ops.adacof")

CONFIG = load_json(Path(__file__).resolve().parents[1] / "benchmark" /
                   "configs" / "adacof_plus.json")
SEED = 2 ** 31 + 25
SPANS = ("vfidkr/adacof/encoder", "vfidkr/adacof/decoder",
         "vfidkr/adacof/kernels", "vfidkr/adacof/sampling")


def _config(f: int, d: int) -> dict:
    """The cell's configuration at F = ``f``, D = ``d``: each per-tap bias
    vector of the taming rewritten for f x f taps (the centre prior and the
    constant offsets as the configuration states them for 11 x 11)."""
    cfg = copy.deepcopy(CONFIG)
    cfg.update(kernel_size=f, dilation=d)
    c = (f - 1) / 2
    prior = [-((i - c) ** 2 + (j - c) ** 2) / 8.0 for i in range(f)
             for j in range(f)]
    for name, vec in cfg["bias_add"].items():
        cfg["bias_add"][name] = (prior if "Weight" in name
                                 else [vec[0]] * (f * f))
    return cfg


def _weights(f=11, d=2, seed=SEED):
    with torch.device("meta"):
        meta = AdaCoFPlus(kernel_size=f, dilation=d)
    return make_state(shapes_of(meta), _config(f, d), seed, "cpu")


def _frames(g, n, h, w):
    coarse = torch.rand(n, 3, h // 8 + 1, w // 8 + 1, generator=g)
    return torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bicubic", align_corners=False).clamp(0, 1)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("f,d", [(11, 2), (5, 1)])
def test_program_matches_the_reference(f, d, n):
    """Tolerance 2e-6 absolute (outputs in [0, 1]): both are float32 on the
    CPU through the same convolutions; the sampling's sums run in another
    order (the plain version's nested bilinear blend against the
    reference's four weighted corners), F^2 terms of a value."""
    state = _weights(f, d)
    model = AdaCoFPlus(kernel_size=f, dilation=d).eval()
    model.load_state_dict(state, strict=True)
    g = torch.Generator().manual_seed(3 + n)
    i0, i2 = _frames(g, n, 64, 96), _frames(g, n, 64, 96)
    with torch.no_grad():
        got = model(i0, i2)["outputs"]
        want = ref.adacof(state, i0, i2, CONFIG["lanes"]["float32"],
                          _config(f, d))[0]
    assert len(got) == len(want) == 1 and got[0].shape == (n, 3, 64, 96)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-6)
    # the tamed weights move the samples: the output is no blend of the
    # frames in place
    assert float((want[0] - (i0 + i2) / 2).abs().mean()) > 1e-2


def test_parameter_counts():
    assert sum(p.numel() for p in AdaCoFPlus().parameters()) == \
        CONFIG["trained_elements"] == 22_933_219
    assert sum(p.numel() for p in AdaCoFPlus(kernel_size=5, dilation=1)
               .parameters()) == 21_843_427
    unet = [p for name, p in AdaCoFPlus().named_parameters()
            if name.startswith(("moduleConv", "moduleDeconv",
                                "moduleUpsample"))]
    assert sum(p.numel() for p in unet) == 21_168_480


def _float64_sample(frame, weight, alpha, beta, dil):
    """The paper's sample, a value at a time in float64: the position u = y
    + i D + alpha clamped to the padded frame, u0 = floor(u), u1 = min(u0 +
    1, Hp - 1), the fraction u - u0 (and v of beta)."""
    fr, wt = frame.double().numpy(), weight.double().numpy()
    al, be = alpha.double().numpy(), beta.double().numpy()
    n, c, h, w = fr.shape
    f = math.isqrt(wt.shape[1])
    pad = dil * (f - 1) // 2
    p = np.pad(fr, ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="edge")
    hp, wp = h + 2 * pad, w + 2 * pad
    out = np.zeros((n, c, h, w))
    for b in range(n):
        for t in range(f * f):
            i, j = divmod(t, f)
            for y in range(h):
                for x in range(w):
                    u = min(max(y + i * dil + al[b, t, y, x], 0.0), hp - 1)
                    v = min(max(x + j * dil + be[b, t, y, x], 0.0), wp - 1)
                    u0, v0 = math.floor(u), math.floor(v)
                    a, e = u - u0, v - v0
                    u1, v1 = min(u0 + 1, hp - 1), min(v0 + 1, wp - 1)
                    s = ((1 - a) * ((1 - e) * p[b, :, u0, v0]
                                    + e * p[b, :, u0, v1])
                         + a * ((1 - e) * p[b, :, u1, v0]
                                + e * p[b, :, u1, v1]))
                    out[b, :, y, x] += wt[b, t, y, x] * s
    return out


def _hard_offsets(g, n, taps, h, w, pad):
    """Offsets that reach every branch: negative fractional values (floor
    and truncation part), whole numbers, and jumps past the pad on every
    side (up to 3 pad + 4 px)."""
    reach = 3 * pad + 4
    alpha = (torch.rand(n, taps, h, w, generator=g) * 2 - 1) * reach
    beta = (torch.rand(n, taps, h, w, generator=g) * 2 - 1) * reach
    alpha[:, :, 0, :] = -0.25                   # just above a whole number
    beta[:, :, :, 0] = -1.75
    alpha[:, :, -1, :] = 2.0                    # whole
    beta[:, :, :, -1] = float(reach)            # past the right pad
    alpha[:, :, 1, 1] = -float(reach)           # past the top pad
    return alpha, beta


@pytest.mark.parametrize("f,d", [(5, 2), (3, 1)])
def test_plain_sampling_against_the_reference_and_float64(f, d,
                                                        monkeypatch):
    """``adacof_plain`` against the reference's ``sample`` (1e-6: float32
    sums in another order) and against the float64 sample at the clamped
    position (1e-5 over the terms' magnitudes: the float32 fraction of an
    offset); truncation toward zero in the reference would differ."""
    g = torch.Generator().manual_seed(f * 10 + d)
    n, h, w, taps = 2, 9, 13, f * f
    pad = d * (f - 1) // 2
    frame = torch.rand(n, 3, h, w, generator=g)
    weight = torch.softmax(torch.randn(n, taps, h, w, generator=g), 1)
    alpha, beta = _hard_offsets(g, n, taps, h, w, pad)
    got = AC.adacof_plain(frame, weight, alpha, beta, d)
    torch.testing.assert_close(got, ref.sample(frame, weight, alpha, beta, d),
                               rtol=0, atol=1e-6)
    want = _float64_sample(frame, weight, alpha, beta, d)
    assert np.abs(got.double().numpy() - want).max() <= 1e-5
    monkeypatch.setattr(ref, "floor", torch.trunc)
    wrong = ref.sample(frame, weight, alpha, beta, d)
    assert float((wrong - got).abs().max()) > 1e-2


def test_adacof_pair_is_the_occlusion_blend_and_checks_its_inputs():
    g = torch.Generator().manual_seed(6)
    n, h, w, f, d = 1, 7, 10, 3, 2
    i0, i2 = torch.rand(2, n, 3, h, w, generator=g)
    w0, w2 = torch.softmax(torch.randn(2, n, f * f, h, w, generator=g), 2)
    a0, b0, a2, b2 = torch.randn(4, n, f * f, h, w, generator=g) * 3
    occ = torch.rand(n, 1, h, w, generator=g)
    want = (occ * AC.adacof_plain(i0, w0, a0, b0, d)
            + (1 - occ) * AC.adacof_plain(i2, w2, a2, b2, d))
    before = kernels.LAUNCHES["adacof"]
    torch.testing.assert_close(
        AC.adacof_pair(i0, w0, a0, b0, i2, w2, a2, b2, occ, d), want,
        rtol=0, atol=0)
    assert kernels.LAUNCHES["adacof"] == before    # the CPU runs the plain one
    with pytest.raises(ValueError, match="F odd"):
        AC.adacof_pair(i0, w0[:, :4], a0[:, :4], b0[:, :4], i2, w2[:, :4],
                       a2[:, :4], b2[:, :4], occ, d)
    with pytest.raises(ValueError, match="occ"):
        AC.adacof_pair(i0, w0, a0, b0, i2, w2, a2, b2, occ[:, :, 1:], d)
    with pytest.raises(ValueError, match="dilation"):
        AC.adacof_pair(i0, w0, a0, b0, i2, w2, a2, b2, occ, 0)
    with pytest.raises(TypeError, match="float32"):
        AC.adacof_pair(i0.double(), w0, a0, b0, i2, w2, a2, b2, occ, d)


def _sepconv_keys():
    """SepConv's state-dict keys in ``run.py``'s order, as the port named
    them before the U-Net was shared."""
    keys = []
    for k in range(1, 6):
        keys += [f"netConv{k}.{i}.{p}" for i in (0, 2, 4)
                 for p in ("weight", "bias")]
    for k in (5, 4, 3, 2):
        keys += [f"netDeconv{k}.{i}.{p}" for i in (0, 2, 4)
                 for p in ("weight", "bias")]
    for k in (5, 4, 3, 2):
        keys += [f"netUpsample{k}.1.{p}" for p in ("weight", "bias")]
    for s in ("netVertical1", "netVertical2", "netHorizontal1",
              "netHorizontal2"):
        keys += [f"{s}.{i}.{p}" for i in (0, 2, 4, 7)
                 for p in ("weight", "bias")]
    return keys


def _sepconv_unshared(model, i0, i2):
    """SepConv's forward as it was written before the U-Net was shared."""
    c1 = model.netConv1(torch.cat([i0, i2], 1))
    c2 = model.netConv2(avg_pool_2x2(c1))
    c3 = model.netConv3(avg_pool_2x2(c2))
    c4 = model.netConv4(avg_pool_2x2(c3))
    c5 = model.netConv5(avg_pool_2x2(c4))
    d5 = model.netUpsample5(model.netDeconv5(avg_pool_2x2(c5)))
    d4 = model.netUpsample4(model.netDeconv4(d5 + c5))
    d3 = model.netUpsample3(model.netDeconv3(d4 + c4))
    d2 = model.netUpsample2(model.netDeconv2(d3 + c3))
    x = d2 + c2
    v1, v2 = model.netVertical1(x), model.netVertical2(x)
    h1, h2 = model.netHorizontal1(x), model.netHorizontal2(x)
    from vfidkr_torch.ops.separable_conv import separable_conv_pair
    return separable_conv_pair(i0, v1, h1, i2, v2, h2)


def _aten_ops(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


def test_sepconv_keeps_its_keys_output_and_ops_on_the_shared_unet():
    """The shared U-Net leaves SepConv as it was: its keys in ``run.py``'s
    order (a published checkpoint still loads strictly), its seeded
    initialisation, its output bit for bit and its ATen ops one for one
    (the card's 156 launches a forward), against the forward written out as
    it was before."""
    model = SepConv(torch.Generator().manual_seed(0)).eval()
    assert list(model.state_dict()) == _sepconv_keys()
    # the U-Net's children are drawn first, in the order they were
    g = torch.Generator().manual_seed(0)
    first = torch.empty(32, 6, 3, 3).normal_(0.0, math.sqrt(2 / 54),
                                             generator=g)
    assert torch.equal(model.netConv1[0].weight, first)
    assert not model.netUpsample2[0].align_corners
    g = torch.Generator().manual_seed(1)
    i0, i2 = _frames(g, 1, 64, 96), _frames(g, 1, 64, 96)
    with torch.inference_mode():
        got = model(i0, i2)["outputs"][0]
        want = _sepconv_unshared(model, i0, i2)
        assert torch.equal(got, want)
        ops = _aten_ops(lambda: model(i0, i2))
        ops_before = _aten_ops(lambda: _sepconv_unshared(model, i0, i2))
    assert ops == ops_before and len(ops) > 50


def test_every_forward_op_lies_in_exactly_one_adacof_span():
    """The four ``vfidkr/adacof/*`` spans, once each inside
    ``vfidkr/forward``, hold every ATen op of the forward, so the per-layer
    metrics that read them add up to the forward."""
    from torch.autograd import DeviceType
    model = AdaCoFPlus(torch.Generator().manual_seed(0), kernel_size=5,
                       dilation=1).eval()
    g = torch.Generator().manual_seed(1)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(_frames(g, 1, 64, 64), _frames(g, 1, 64, 64))
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


def test_registry_config_time_step_and_autotuner():
    """AdaCoFPlus is registered at F = 11, D = 2, interpolates at t = 0.5
    only, in float32 only; ``ModelConfig.build`` turns cuDNN's autotuner on
    for it, as for SepConv.  The trainer does not take it."""
    from vfidkr_torch.config import TRAIN_NET_NAMES
    assert MODEL_REGISTRY["AdaCoFPlus"] is AdaCoFPlus
    assert "AdaCoFPlus" in NET_NAMES and "AdaCoFPlus" not in TRAIN_NET_NAMES
    saved = torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = False
        with torch.device("meta"):
            model = ModelConfig(net_name="AdaCoFPlus").build()
        assert torch.backends.cudnn.benchmark is True
    finally:
        torch.backends.cudnn.benchmark = saved
    assert isinstance(model, AdaCoFPlus)
    assert (model.kernel_size, model.dilation) == (11, 2)
    assert model.moduleUpsample2[0].align_corners
    with pytest.raises(ValueError, match="t = 0.5"):
        ModelConfig(net_name="AdaCoFPlus", time_step=0.25)
    with pytest.raises(ValueError, match="float32"):
        AdaCoFPlus(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="odd"):
        AdaCoFPlus(kernel_size=4)
    with pytest.raises(ValueError, match="divisible by 32"):
        AdaCoFPlus(kernel_size=3, dilation=1)(torch.rand(1, 3, 40, 64),
                                              torch.rand(1, 3, 40, 64))


def test_video_driver_runs_adacof(tmp_path):
    """``apps/interpolate_video.py --model AdaCoFPlus`` on two 64 x 96 PNG
    frames: both passed through and one frame synthesised between them, the
    driver's default output (``--save-which``) the model's one frame."""
    from vfidkr_torch.apps.interpolate_video import main
    from vfidkr_torch.utils.image_io import read_png, write_png
    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        write_png(str(src / f"{i:03d}.png"),
                  rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    summary = main(["--frames-dir", str(src), "--out-dir", str(out),
                    "--model", "AdaCoFPlus", "--device", "cpu"])
    assert summary["interpolated_frames"] == 1
    names = sorted(p.name for p in out.iterdir())
    assert names == ["00001000.png", "00001001.png", "00002000.png"]
    assert read_png(str(out / "00001001.png")).shape == (64, 96, 3)
