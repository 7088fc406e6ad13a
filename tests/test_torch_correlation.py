"""PWC-Net's cost volume, ``ops.correlation.cost_volume``, on the CPU.

On CPU tensors the wrapper runs its plain version, which is the chain of
plain ops PWC-Net ran before (the volume, then LeakyReLU(0.1)) bit for bit;
K13 itself runs only on the card (``tests/test_torch_cuda.py``).  Here: the
plain backward (the two gathers K13's backward computes) against autograd
of the plain forward at each level's C, with odd H and W and C that no stage
of 8 or 4 channels divides; the wrapper against the old chain, forward and
gradients; its checks; the autograd node's gradients with the plain
versions standing in for the kernels; the arguments it hands
``kernels.launch``; PWC-Net's flow unchanged.
"""
import pytest
import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.kernels import build
from vfidkr_torch.models import pwcnet
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.ops import correlation as CV

# PWC-Net's feature channels at levels 6 .. 2, then C = 1 and C that no
# stage divides
CHANNELS = [196, 128, 96, 64, 32, 1, 13, 37]


def _old_corr(a, b):
    """``PWCDCNet._corr`` as it was: LeakyReLU(0.1) of the plain volume."""
    return F.leaky_relu(CV.correlation_cost_volume(a, b, 4), 0.1)


def _inputs(n, c, h, w, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, c, h, w, generator=g, dtype=dtype),
            torch.randn(n, c, h, w, generator=g, dtype=dtype),
            torch.randn(n, CV.NCORR, h, w, generator=g, dtype=dtype))


@pytest.mark.parametrize("c", CHANNELS)
def test_plain_backward_is_autograd(c):
    """The two gathers give autograd's gradients of the plain forward
    (float64, within summation-order rounding), at odd H and W and at maps
    narrower than the displacements' reach."""
    for n, h, w in ((2, 7, 11), (1, 3, 5), (1, 9, 13)):
        f1, f2, g = _inputs(n, c, h, w, seed=c + h, dtype=torch.float64)
        a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        out = _old_corr(a1, a2)
        want = torch.autograd.grad(out, (a1, a2), g)
        got = CV.cost_volume_bwd_plain(f1, f2, out.detach(), g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_plain_backward_slope_from_the_output_sign():
    """Where the volume is negative the gradient takes the LeakyReLU's
    slope 0.1, where it is positive 1; both halves reached."""
    f1, f2, g = _inputs(1, 3, 6, 10, seed=3, dtype=torch.float64)
    out = CV.cost_volume_plain(f1, f2)
    assert bool((out > 0).any()) and bool((out < 0).any())
    ones = torch.ones_like(out)
    pos = CV.cost_volume_bwd_plain(f1, f2, ones, g)
    neg = CV.cost_volume_bwd_plain(f1, f2, -ones, g)
    for p, q in zip(pos, neg):
        torch.testing.assert_close(q, p * 0.1, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grad", [False, True])
def test_wrapper_on_cpu_is_the_old_chain(grad):
    """On CPU tensors the wrapper gives the old ``_corr``'s bits, and under
    autograd its gradients' bits; it launches nothing."""
    before = dict(kernels.LAUNCHES)
    for n, c, h, w in ((2, 32, 10, 16), (1, 196, 5, 8), (3, 13, 7, 11)):
        f1, f2, g = _inputs(n, c, h, w, seed=n * c)
        a1, a2 = f1.clone().requires_grad_(grad), f2.clone().requires_grad_(
            grad)
        b1, b2 = f1.clone().requires_grad_(grad), f2.clone().requires_grad_(
            grad)
        got, want = CV.cost_volume(a1, a2), _old_corr(b1, b2)
        assert got.shape == (n, 81, h, w)
        assert torch.equal(got, want)
        assert torch.equal(CV.cost_volume_plain(f1, f2), want.detach())
        if grad:
            for x, y in zip(torch.autograd.grad(got, (a1, a2), g),
                            torch.autograd.grad(want, (b1, b2), g)):
                assert torch.equal(x, y)
    assert kernels.LAUNCHES == before


def _bad(case):
    f1, f2, _ = _inputs(2, 8, 6, 9, seed=4)
    md = 4
    if case == "bfloat16":
        f1, f2 = f1.bfloat16(), f2.bfloat16()
    elif case == "f2 float64":
        f2 = f2.double()
    elif case == "f1 not contiguous":
        f1 = torch.randn(2, 8, 9, 6).transpose(2, 3)
    elif case == "f2 not contiguous":
        f2 = torch.randn(2, 8, 9, 6).transpose(2, 3)
    elif case == "channels differ":
        f2 = f2[:, :7].contiguous()
    elif case == "sizes differ":
        f2 = f2[:, :, :5].contiguous()
    elif case == "md 3":
        md = 3
    elif case == "md 5":
        md = 5
    elif case == "3-d":
        f1, f2 = f1[0], f2[0]
    elif case == "empty":
        f1, f2 = f1[:0], f2[:0]
    elif case == "f2 on another device":
        f2 = f2.to("meta")
    return f1, f2, md


@pytest.mark.parametrize("case, error", [
    ("bfloat16", TypeError), ("f2 float64", TypeError),
    ("f1 not contiguous", ValueError), ("f2 not contiguous", ValueError),
    ("channels differ", ValueError), ("sizes differ", ValueError),
    ("md 3", ValueError), ("md 5", ValueError), ("3-d", ValueError),
    ("empty", ValueError), ("f2 on another device", ValueError)])
def test_cost_volume_rejects(case, error):
    """The checks run on every device, before the dispatch."""
    f1, f2, md = _bad(case)
    with pytest.raises(error):
        CV.cost_volume(f1, f2, md)


def test_autograd_node_gives_the_plain_gradients(monkeypatch):
    """The autograd node that carries K13 on the card, with the plain
    versions standing in for its two entry points, gives autograd's
    gradients of the plain forward; a frozen input gets none and its pass
    is not asked for."""
    asked = []

    def fake_bwd(f1, f2, out, g, need1, need2):
        asked.append((need1, need2))
        gf1, gf2 = CV.cost_volume_bwd_plain(f1, f2, out, g)
        return (gf1 if need1 else None), (gf2 if need2 else None)

    monkeypatch.setattr(CV, "_launch", CV.cost_volume_plain)
    monkeypatch.setattr(CV, "_launch_bwd", fake_bwd)
    f1, f2, g = _inputs(2, 37, 7, 11, seed=9, dtype=torch.float64)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = CV._CostVolume.apply(a1, a2)
    assert type(out.grad_fn).__name__ == "_CostVolumeBackward"
    got = torch.autograd.grad(out, (a1, a2), g)
    b1, b2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    want = torch.autograd.grad(_old_corr(b1, b2), (b1, b2), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    (frozen,) = torch.autograd.grad(CV._CostVolume.apply(f1, a2), (a2,), g)
    torch.testing.assert_close(frozen, want[1], rtol=1e-12, atol=1e-12)
    assert asked == [(True, True), (False, True)]


def test_launches_hand_the_kernels_their_signatures(monkeypatch):
    """The wrapper's two launches pass the arguments of the entry points'
    C signatures, in order: the tensors, the sizes, a null pointer for a
    gradient not asked for."""
    calls = []
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    f1, f2, g = _inputs(3, 13, 7, 40, seed=2)
    out = CV._launch(f1, f2)
    gf1, gf2 = CV._launch_bwd(f1, f2, out, g, False, True)
    (n1, a1), (n2, a2) = calls
    assert n1 == "correlation" and n2 == "correlation_bwd"
    for name, args in calls:
        assert len(args) == len(build.SIGNATURES[f"vfidkr_{name}"]) - 1
    assert a1[:3] == (f1, f2, out) and a1[3:] == (3, 13, 7, 40)
    assert out.shape == (3, 81, 7, 40) and out.dtype == torch.float32
    assert a2[:4] == (f1, f2, out, g) and a2[4] is None and a2[5] is gf2
    assert a2[6:] == (3, 13, 7, 40)
    assert gf1 is None and gf2.shape == f2.shape


@pytest.fixture(scope="module")
def net():
    return PWCDCNet(generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("grad", [False, True])
def test_pwcnet_flow_unchanged(net, grad, monkeypatch):
    """A PWC-Net forward at 64 x 64 gives the old chain's flow bit for bit,
    both directions of the bidirectional pass too, and under autograd the
    frames' gradients too; no kernel launches."""
    g = torch.Generator().manual_seed(3)
    im1, im2 = torch.rand(2, 1, 3, 64, 64, generator=g)
    cot = torch.randn(1, 2, 16, 16, generator=g)

    def run():
        a = im1.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            flow = net(a, im2)
            bi = net.bidirectional(a, im2)
        grads = (torch.autograd.grad((flow * cot).sum(), a) if grad
                 else ())
        return (flow, *bi, *grads)

    before = dict(kernels.LAUNCHES)
    got = run()
    monkeypatch.setattr(pwcnet, "cost_volume",
                        lambda a, b, md: _old_corr(a, b))
    want = run()
    assert kernels.LAUNCHES == before
    assert len(got) == (4 if grad else 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
