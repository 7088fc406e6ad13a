"""SepConv in the port (``models/sepconv.py``) and its local convolution
(``ops.separable_conv.separable_conv_pair``, the kernel K9 on the card).

On the CPU: the network at its published widths (fs = 51) against the
benchmark's plain reference (``benchmark/reference/sepconv.py``) on seeded
weights; the plain ``separable_conv`` against a float64 direct sum; the
time-step rule; the video driver's ``frames_between`` on SepConv.  On the
card only (marker ``cuda``; no JAX is imported here):

    python -m pytest --noconftest -m cuda tests/test_torch_sepconv.py -q

K9 against the plain version in float64, at the cell's 1984 x 1152 and at
a ragged size that no tile divides.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib.cell import load_json  # noqa: E402
from benchmark.lib.weights import make_state, shapes_of  # noqa: E402
from benchmark.reference import sepconv as ref  # noqa: E402
from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.config import ModelConfig  # noqa: E402
from vfidkr_torch.models import SepConv  # noqa: E402
# the module (``vfidkr_torch.ops`` exports its function of the same name)
SC = importlib.import_module("vfidkr_torch.ops.separable_conv")

CONFIG = load_json(Path(__file__).resolve().parents[1] / "benchmark" /
                   "configs" / "sepconv.json")
SEED = 2 ** 31 + 19


def _weights(seed=SEED):
    with torch.device("meta"):
        meta = ModelConfig("SepConv").build()
    return make_state(shapes_of(meta), CONFIG, seed, "cpu")


def _frames(g, n, h, w):
    coarse = torch.rand(n, 3, h // 8 + 1, w // 8 + 1, generator=g)
    return torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bicubic", align_corners=False).clamp(0, 1)


def test_program_matches_the_reference_at_published_widths():
    """Tolerance 1e-6 absolute (outputs near 0.5): both are float32 on the
    CPU, the local convolution's sums in another order (the slice loop
    against the reference's row of taps as a batched product)."""
    state = _weights()
    model = SepConv().eval()
    model.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in model.parameters()) == \
        CONFIG["trained_elements"]
    g = torch.Generator().manual_seed(3)
    i0, i2 = _frames(g, 1, 64, 96), _frames(g, 1, 64, 96)
    with torch.no_grad():
        got = model(i0, i2)["outputs"]
        want = ref.sepconv(state, i0, i2, CONFIG["lanes"]["float32"],
                           CONFIG)[0]
    assert len(got) == len(want) == 1 and got[0].shape == (1, 3, 64, 96)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    # the tamed weights keep the frame inside [0, 1] and the kernels alive
    assert 0.0 < float(want[0].min()) and float(want[0].max()) < 1.0


def test_plain_separable_conv_against_a_float64_direct_sum():
    """Tolerance 2e-6 of the float64 sum of the terms' magnitudes: float32
    products and sums, 51 x 51 of them a value."""
    g = torch.Generator().manual_seed(5)
    n, c, h, w, fs = 2, 3, 57, 60, 51
    image = torch.rand(n, c, h, w, generator=g)
    vert = torch.rand(n, fs, h - fs + 1, w - fs + 1, generator=g) - 0.3
    horiz = torch.rand(n, fs, h - fs + 1, w - fs + 1, generator=g) - 0.3
    got = SC.separable_conv(image, vert, horiz).double()
    im, v, hz = image.double().numpy(), vert.double().numpy(), \
        horiz.double().numpy()
    ho, wo = h - fs + 1, w - fs + 1
    want = np.zeros((n, c, ho, wo))
    mag = np.zeros((n, c, ho, wo))
    for j in range(fs):
        for i in range(fs):
            term = im[:, :, j:j + ho, i:i + wo] * (v[:, None, j] *
                                                   hz[:, None, i])
            want += term
            mag += np.abs(term)
    err = np.abs(got.numpy() - want)
    assert (err <= 2e-6 * mag).all(), float((err / mag).max())


def test_pair_plain_is_two_padded_separable_convs():
    g = torch.Generator().manual_seed(6)
    n, h, w, fs = 1, 9, 13, 5
    i0, i2 = torch.rand(2, n, 3, h, w, generator=g)
    v1, h1, v2, h2 = torch.rand(4, n, fs, h, w, generator=g)
    pad = lambda x: torch.nn.functional.pad(x, (2, 2, 2, 2),
                                            mode="replicate")
    want = (SC.separable_conv(pad(i0), v1, h1)
            + SC.separable_conv(pad(i2), v2, h2))
    torch.testing.assert_close(
        SC.separable_conv_pair(i0, v1, h1, i2, v2, h2), want, rtol=0, atol=0)
    assert kernels.LAUNCHES["sepconv_pair"] == 0   # the CPU runs the plain one
    with pytest.raises(ValueError, match="odd"):
        SC.separable_conv_pair(i0, v1[:, :4], h1[:, :4], i2, v2[:, :4],
                               h2[:, :4])


def test_sepconv_interpolates_at_the_middle_only():
    with pytest.raises(ValueError, match="t = 0.5"):
        ModelConfig(net_name="SepConv", time_step=0.25)
    with pytest.raises(ValueError, match="float32"):
        SepConv(compute_dtype="bfloat16")
    assert isinstance(ModelConfig(net_name="SepConv").build(), SepConv)


def test_frames_between_on_sepconv_gives_one_uint8_frame():
    """The driver's defaults pick SepConv's one output: the flag's and the
    function's (``EvalConfig.save_which``)."""
    from vfidkr_torch.apps.interpolate_video import (build_parser,
                                                     frames_between, to_input)
    model = SepConv(torch.Generator().manual_seed(0))
    model.load_state_dict(_weights(), strict=True)
    model.eval()
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (70, 100, 3), dtype=np.uint8)
            for _ in range(2))
    a_in, pads = to_input(a, "cpu")
    b_in, _ = to_input(b, "cpu")
    args = build_parser().parse_args(["--frames-dir", "f", "--model",
                                      "SepConv"])
    out = frames_between(model, a_in, b_in, pads, args.save_which)
    assert out.shape == (1, 70, 100, 3) and out.dtype == torch.uint8
    assert torch.equal(frames_between(model, a_in, b_in, pads), out)


def test_build_turns_on_cudnns_autotuner_for_sepconv_only():
    """``ModelConfig.build`` sets the process's flag for a network that
    needs it (SepConv), once, and leaves it as it is for DAIN; the forward
    leaves it alone."""
    saved = torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = False
        with torch.device("meta"):
            ModelConfig("DAIN").build()
        assert torch.backends.cudnn.benchmark is False
        model = ModelConfig("SepConv").build(
            torch.Generator().manual_seed(0)).eval()
        assert torch.backends.cudnn.benchmark is True
        torch.backends.cudnn.benchmark = False
        g = torch.Generator().manual_seed(1)
        with torch.inference_mode():
            model(_frames(g, 1, 32, 32), _frames(g, 1, 32, 32))
        assert torch.backends.cudnn.benchmark is False
    finally:
        torch.backends.cudnn.benchmark = saved


def test_every_forward_op_lies_in_exactly_one_sepconv_span():
    """The four ``vfidkr/sepconv/*`` spans, once each inside
    ``vfidkr/forward``, hold every ATen op of the forward, so the per-layer
    metrics that read them add up to the forward."""
    from torch.autograd import DeviceType
    spans = ("vfidkr/sepconv/encoder", "vfidkr/sepconv/decoder",
             "vfidkr/sepconv/kernels", "vfidkr/sepconv/local_conv")
    model = SepConv(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(_frames(g, 1, 64, 64), _frames(g, 1, 64, 64))
    ev = [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CPU]
    inside = lambda e, o: (e[2] == o[2] and o[0] <= e[0] and e[1] <= o[1])
    (fwd,) = [e for e in ev if e[3] == "vfidkr/forward"]
    stages = [e for e in ev if e[3] in spans]
    assert sorted(e[3] for e in stages) == sorted(spans)
    assert all(inside(s, fwd) for s in stages)
    ops = [e for e in ev if e[3].startswith("aten::") and inside(e, fwd)]
    assert len(ops) > 50
    for op in ops:
        assert sum(inside(op, s) for s in stages) == 1, op


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(1, 1152, 1984), (2, 37, 75)])
def test_k9_against_the_plain_version(dev, n, h, w):
    """Error over the float64 sum of the terms' magnitudes (the plain
    version on |inputs|), 2e-6: float32 sums in another order."""
    g = torch.Generator(device=dev).manual_seed(h * w)
    i0, i2 = torch.rand(2, n, 3, h, w, generator=g, device=dev)
    v1, h1, v2, h2 = (torch.rand(4, n, 51, h, w, generator=g, device=dev)
                      - 0.2) * 0.04
    before = kernels.LAUNCHES["sepconv_pair"]
    with torch.inference_mode():
        got = SC.separable_conv_pair(i0, v1, h1, i2, v2, h2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sepconv_pair"] == before + 1
    d = lambda *t: [x.double() for x in t]
    want = SC.separable_conv_pair_plain(*d(i0, v1, h1, i2, v2, h2))
    mag = SC.separable_conv_pair_plain(*d(i0, v1.abs(), h1.abs(), i2,
                                          v2.abs(), h2.abs()))
    err = (got.double() - want).abs()
    assert bool((err <= 2e-6 * mag).all()), float((err / mag).max())
    with torch.inference_mode():
        again = SC.separable_conv_pair(i0, v1, h1, i2, v2, h2)
    assert torch.equal(got, again)     # one fixed order of sums


@pytest.mark.cuda
def test_k9_refuses_what_it_does_not_take(dev):
    i0 = torch.rand(1, 3, 8, 8, device=dev)
    f = torch.rand(1, 51, 8, 8, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        SC.separable_conv_pair(i0, f, f, i0, f, f)
    f = f.detach()
    with pytest.raises(ValueError, match="3 channels"):
        x = torch.rand(1, 4, 8, 8, device=dev)
        SC.separable_conv_pair(x, f, f, x, f, f)
