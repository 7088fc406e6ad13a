"""PWC-Net's dense-block convs, ``ops.dense_conv``, on the CPU.

On CPU tensors the wrappers run their plain version, which is the
``conv{lvl}_{i}`` module (conv, bias, LeakyReLU(0.1)) bit for bit; K10 itself
runs only on the card (``tests/test_torch_cuda.py``).  Here: the dense block
without autograd (one buffer, no join) and under autograd (fresh outputs
joined by ``torch.cat``) against the block as it ran before, their
gradients, the wrappers' checks, the split's choice, the launch counter,
the parameters' names and the ``vfidkr/flow/decoder`` span.
"""
import pytest
import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.models import pwcnet
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.ops import dense_conv as DC

LEVELS = [(6, 81), (5, 213), (4, 181), (3, 149), (2, 117)]


@pytest.fixture(scope="module")
def net():
    m = PWCDCNet(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():   # biases that are not zero, so the sums show them
        g = torch.Generator().manual_seed(1)
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.05, 0.05, generator=g)
    return m


def _x(c, n=2, h=6, w=9, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, c, h, w, generator=g)


def _joined(net, lvl, x):
    """The dense block as it ran before: each ``conv{lvl}_{i}`` module's
    output joined before its input by ``torch.cat``."""
    for i in range(5):
        x = torch.cat([getattr(net, f"conv{lvl}_{i}")(x), x], 1)
    return x


@pytest.mark.parametrize("lvl,od", LEVELS)
def test_plain_dense_conv_is_the_module(net, lvl, od):
    """Each wrapper on CPU tensors gives its ``conv{lvl}_{i}`` module's bits
    and launches nothing: ``dense_conv`` a fresh tensor, ``dense_conv_into``
    the slot before its input in a buffer."""
    before = kernels.LAUNCHES["dense_conv"]
    x = _x(od, seed=lvl)
    for i in range(5):
        seq = getattr(net, f"conv{lvl}_{i}")
        conv = seq[0]
        with torch.no_grad():
            want = seq(x)
            got = DC.dense_conv(x, conv.weight, conv.bias)
            buf = torch.full((2, conv.out_channels + 3 + x.shape[1], 6, 9),
                             7.0)
            buf[:, conv.out_channels + 3:] = x
            DC.dense_conv_into(buf, conv.out_channels + 3, conv.weight,
                               conv.bias)
        assert torch.equal(got, want)
        assert torch.equal(buf[:, 3:conv.out_channels + 3], want)
        assert bool((buf[:, :3] == 7.0).all())
        assert bool((want < 0).any()) and bool((want > 0).any())
        x = torch.cat([want, x], 1)
    assert kernels.LAUNCHES["dense_conv"] == before


@pytest.mark.parametrize("lvl,od", LEVELS)
def test_dense_block_paths_equal_the_join(net, lvl, od):
    """The block without autograd (one buffer) and under autograd (fresh
    outputs, ``torch.cat``) both give the joined block's bits, in its
    channel order (newest output first, the input last)."""
    x = _x(od, seed=10 + lvl)
    with torch.no_grad():
        want = _joined(net, lvl, x)
        buffered = net._dense(lvl, x)
    traced = net._dense(lvl, x)
    assert traced.grad_fn is not None and buffered.grad_fn is None
    assert buffered.shape == want.shape == (2, od + 448, 6, 9)
    assert buffered.is_contiguous()
    assert torch.equal(buffered, want)
    assert torch.equal(traced.detach(), want)
    assert torch.equal(buffered[:, 448:], x)


@pytest.mark.parametrize("lvl,od", [LEVELS[0], LEVELS[-1]])
def test_dense_block_gradients_equal_the_join(net, lvl, od):
    """Under autograd the block's gradients (input, every conv's weight and
    bias) are the joined block's bit for bit."""
    x = _x(od, seed=20 + lvl).requires_grad_()
    cot = torch.randn(2, od + 448, 6, 9,
                      generator=torch.Generator().manual_seed(21))
    leaves = [x] + [p for i in range(5)
                    for p in getattr(net, f"conv{lvl}_{i}").parameters()]
    got = torch.autograd.grad((net._dense(lvl, x) * cot).sum(), leaves)
    want = torch.autograd.grad((_joined(net, lvl, x) * cot).sum(), leaves)
    assert len(got) == 11
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_forward_unchanged_and_nothing_launched(net):
    """A PWC-Net forward on the CPU gives the same flow with and without
    autograd, equal to the forward with the joined block, and launches no
    K10."""
    g = torch.Generator().manual_seed(3)
    im1, im2 = torch.rand(2, 1, 3, 64, 128, generator=g)
    before = kernels.LAUNCHES["dense_conv"]
    with torch.no_grad():
        got = net(im1, im2)
    traced = net(im1, im2)
    real = net._dense
    net._dense = lambda lvl, x: _joined(net, lvl, x)
    try:
        with torch.no_grad():
            want = net(im1, im2)
    finally:
        del net._dense
    assert net._dense.__func__ is real.__func__
    assert torch.equal(got, want) and torch.equal(traced.detach(), want)
    assert kernels.LAUNCHES["dense_conv"] == before


def _bad(case):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 13, 6, 9, generator=g)
    w = torch.randn(64, 13, 3, 3, generator=g)
    b = torch.randn(64, generator=g)
    if case == "x float64":
        x = x.double()
    elif case == "w bfloat16":
        w = w.bfloat16()
    elif case == "b float64":
        b = b.double()
    elif case == "x not contiguous":
        x = torch.randn(2, 13, 9, 6, generator=g).transpose(2, 3)
    elif case == "w not contiguous":
        w = w.transpose(2, 3)
    elif case == "kernel 1x1":
        w = w[:, :, 1:2, 1:2].contiguous()
    elif case == "kernel 5x5":
        w = torch.randn(64, 13, 5, 5, generator=g)
    elif case == "48 output channels":
        w, b = w[:48].contiguous(), b[:48].contiguous()
    elif case == "16 output channels":
        w, b = w[:16].contiguous(), b[:16].contiguous()
    elif case == "channels differ":
        x = x[:, :12].contiguous()
    elif case == "b's length":
        b = b[:63].contiguous()
    elif case == "x 3-d":
        x = x[0]
    elif case == "x empty":
        x = x[:0]
    return x, w, b


CASES = [("x float64", TypeError), ("w bfloat16", TypeError),
         ("b float64", TypeError), ("w not contiguous", ValueError),
         ("kernel 1x1", ValueError), ("kernel 5x5", ValueError),
         ("48 output channels", ValueError),
         ("16 output channels", ValueError), ("channels differ", ValueError),
         ("b's length", ValueError), ("x 3-d", ValueError),
         ("x empty", ValueError)]


@pytest.mark.parametrize("case, error", CASES + [("x not contiguous",
                                                  ValueError)])
def test_dense_conv_rejects(case, error):
    """The checks run on every device, before the dispatch."""
    x, w, b = _bad(case)
    with pytest.raises(error):
        DC.dense_conv(x, w, b)


@pytest.mark.parametrize("case, error", CASES)
def test_dense_conv_into_rejects(case, error):
    """The buffer call makes the same checks on the buffer's input
    channels."""
    x, w, b = _bad(case)
    if x.dim() == 4:
        buf = torch.cat([torch.zeros(x.shape[0], w.shape[0], *x.shape[2:],
                                     dtype=x.dtype), x], 1)
    else:
        buf = x
    with pytest.raises(error):
        DC.dense_conv_into(buf, w.shape[0], w, b)


@pytest.mark.parametrize("case", ["output before channel 0",
                                  "input past the end", "not contiguous",
                                  "autograd"])
def test_dense_conv_into_rejects_its_own(case):
    """The buffer must hold both channel ranges, be contiguous, and take no
    autograd (it is written in place)."""
    x, w, b = _bad("none")
    buf = torch.zeros(2, 64 + 13, 6, 9)
    start = 64
    if case == "output before channel 0":
        start = 63
    elif case == "input past the end":
        buf = buf[:, :-1].contiguous()
    elif case == "not contiguous":
        buf = torch.zeros(2, 6, 64 + 13, 9).transpose(1, 2)
    elif case == "autograd":
        w = w.requires_grad_()
    with pytest.raises(ValueError):
        DC.dense_conv_into(buf, start, w, b)
    with torch.no_grad():
        if case == "autograd":
            DC.dense_conv_into(buf, start, w, b)


def test_plan_follows_the_shape():
    """The tile and the split come from the shape alone: no split where the
    frame fills the card with the large tile (cell 2's level 2, a B = 40
    training batch), the small tile and a cluster of up to 16 where it does
    not (cell 1's levels 3 to 6), a power of two and never more blocks
    than stages of 8 input channels."""
    sms = 132
    assert DC.plan(2, 192, 336, 117, 128, sms) == (DC.LARGE, 1)
    assert DC.plan(2, 192, 336, 533, 32, sms) == (DC.SMALL, 1)
    assert DC.plan(80, 64, 112, 117, 128, sms) == (DC.LARGE, 1)
    assert DC.plan(6, 64, 112, 117, 128, sms) == (DC.SMALL, 1)
    for h, w, cin in ((40, 64, 149), (20, 32, 181), (10, 16, 213),
                      (5, 8, 81)):
        rows, split = DC.plan(2, h, w, cin, 128, sms)
        assert rows == DC.SMALL and 1 < split <= DC.MAX_SPLIT
    assert DC.plan(1, 5, 8, 12, 32, sms) == (DC.SMALL, 2)   # 2 stages of 8
    assert DC.plan(1, 5, 8, 3, 32, sms) == (DC.SMALL, 1)
    for cin in range(1, 700, 37):
        for cout in (32, 64, 96, 128):
            rows, s = DC.plan(2, 20, 32, cin, cout, sms)
            assert rows in (DC.SMALL, DC.LARGE)
            assert 1 <= s <= min(DC.MAX_SPLIT, -(-cin // DC.STAGE_C))
            assert s & (s - 1) == 0
    assert DC.plan(2, 20, 32, 181, 128, sms) == DC.plan(2, 20, 32, 181, 128,
                                                        sms)


def test_state_dict_keys_unchanged(net):
    """The dense convs keep the reference's names
    (``conv{lvl}_{i}.0.weight``), so published checkpoints load strictly."""
    keys = set(net.state_dict())
    for lvl, od in LEVELS:
        cin = od
        for i, cout in enumerate((128, 128, 96, 64, 32)):
            assert tuple(net.state_dict()[f"conv{lvl}_{i}.0.weight"].shape) \
                == (cout, cin, 3, 3)
            assert f"conv{lvl}_{i}.0.bias" in keys
            cin += cout
    PWCDCNet().load_state_dict(net.state_dict(), strict=True)


@pytest.mark.parametrize("grad", [False, True])
def test_decoder_span_holds_the_dense_blocks(net, grad):
    """Under a profiler a forward records five ``vfidkr/flow/decoder``
    spans, which hold the 25 dense convs and the 5 flow heads; without
    autograd no dense block joins by ``torch.cat`` (the 4 left are the
    levels' inputs), under autograd each conv's output is joined."""
    g = torch.Generator().manual_seed(5)
    im1, im2 = torch.rand(2, 1, 3, 64, 64, generator=g)
    with torch.set_grad_enabled(grad), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net(im1, im2)
    events = prof.events()
    spans = [e for e in events if e.name == "vfidkr/flow/decoder"]
    assert len(spans) == 5

    def inside(name):
        return [e for e in events if e.name == name and any(
            s.time_range.start <= e.time_range.start
            and e.time_range.end <= s.time_range.end for s in spans)]
    assert len(inside("aten::conv2d")) == 30
    assert len(inside("aten::leaky_relu")) == 25
    assert len(inside("aten::cat")) == (29 if grad else 4)


def test_dense_span_untouched_without_profiler(monkeypatch):
    """The decoder's spans are the ones the module names."""
    spans = []
    real = pwcnet.span

    def spy(name):
        spans.append(name)
        return real(name)

    monkeypatch.setattr(pwcnet, "span", spy)
    m = PWCDCNet()
    with torch.no_grad():
        m(torch.rand(1, 3, 64, 64), torch.rand(1, 3, 64, 64))
    assert spans.count("vfidkr/flow/decoder") == 5
    assert spans.count("vfidkr/flow/cost_volume") == 5
    assert spans[0] == "vfidkr/flow/pyramid"
    assert spans[-1] == "vfidkr/flow/refine"


def test_plain_version_is_leaky_relu_of_conv():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 5, 4, 7, generator=g)
    w, b = torch.randn(32, 5, 3, 3, generator=g), torch.randn(32, generator=g)
    want = F.leaky_relu(F.conv2d(x, w, b, padding=1), 0.1)
    assert torch.equal(DC.dense_conv_plain(x, w, b), want)


def test_autograd_nodes_give_the_plain_gradients(monkeypatch):
    """The two autograd nodes that carry K10 on the card (conv and bias,
    then the activation from the saved output) give the plain version's
    gradients bit for bit, the plain forward standing in for the kernel;
    the activation's node is the output's."""
    monkeypatch.setattr(DC, "_fresh", lambda x, w, b: DC.dense_conv_plain(
        x.detach(), w.detach(), b.detach()))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 13, 6, 9, generator=g, requires_grad=True)
    w = torch.randn(64, 13, 3, 3, generator=g, requires_grad=True)
    b = torch.randn(64, generator=g, requires_grad=True)
    out = DC._LeakyReluOfOutput.apply(DC._DenseConv.apply(x, w, b))
    assert type(out.grad_fn).__name__ == "_LeakyReluOfOutputBackward"
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad((out * cot).sum(), (x, w, b))
    want = torch.autograd.grad(
        (DC.dense_conv_plain(x, w, b) * cot).sum(), (x, w, b))
    for a, c in zip(got, want):
        assert torch.equal(a, c)
