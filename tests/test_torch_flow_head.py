"""PWC-Net's flow heads, ``ops.flow_head``, on the CPU.

On CPU tensors the wrapper runs its plain version, which is the
``predict_flow{lvl}`` module (conv and bias) bit for bit; K11 itself runs
only on the card (``tests/test_torch_cuda.py``).  Here: the plain version
against each level's module, the decoder's flow against the module path,
the autograd node's gradients, the wrapper's checks, the plan's tile and
split and the channels each block takes, the parameters' names and the
``vfidkr/flow/heads`` span.
"""
import math

import pytest
import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.models import pwcnet
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.ops import flow_head as FH

# (level, the head's input channels): the decoder's od + the dense block's 448
LEVELS = [(6, 529), (5, 661), (4, 629), (3, 597), (2, 565)]
# each level's map of a bidirectional decode: (cell, batch, level, H, W) of
# cells 1 and 4 (a 512 x 320 pair), 2 (1344 x 768), 3 and 6 (B = 3 at
# 256 x 448) and 5 (B = 40 at 256 x 448)
CELL_LEVELS = [(cell, n, lvl, hh >> lvl, ww >> lvl)
               for cell, n, hh, ww in (("cells 1, 4", 2, 320, 512),
                                       ("cell 2", 2, 768, 1344),
                                       ("cells 3, 6", 6, 256, 448),
                                       ("cell 5", 80, 256, 448))
               for lvl in (2, 3, 4, 5, 6)]
C = dict(LEVELS)


@pytest.fixture(scope="module")
def net():
    m = PWCDCNet(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():   # biases that are not zero, so the sums show them
        g = torch.Generator().manual_seed(1)
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.05, 0.05, generator=g)
    return m


def _channel_runs(c, split):
    """Block r's input channels ``[lo, hi)`` for r in 0 .. split - 1, as K11
    divides them (``csrc/flow_head.cu``: ``k_lo``, ``k_hi``): whole stages
    of 8 channels, block r taking stages ``r * stages // split`` up to
    ``(r + 1) * stages // split``."""
    stages = math.ceil(c / FH.STAGE_C)
    return [(r * stages // split * FH.STAGE_C,
             min((r + 1) * stages // split * FH.STAGE_C, c))
            for r in range(split)]


def _x(c, n=2, h=6, w=9, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, c, h, w, generator=g)


@pytest.mark.parametrize("lvl,c", LEVELS)
def test_plain_flow_head_is_the_module(net, lvl, c):
    """On CPU tensors the wrapper gives its ``predict_flow{lvl}`` module's
    bits, at a small map and a ragged one, and launches nothing."""
    head = getattr(net, f"predict_flow{lvl}")
    before = dict(kernels.LAUNCHES)
    for n, h, w in ((2, 6, 9), (1, 5, 8), (3, 4, 7)):
        x = _x(c, n, h, w, seed=lvl + h)
        with torch.no_grad():
            want = head(x)
            got = FH.flow_head(x, head.weight, head.bias)
        assert got.shape == (n, 2, h, w)
        assert torch.equal(got, want)
        assert torch.equal(FH.flow_head_plain(x, head.weight, head.bias),
                           want)
    assert kernels.LAUNCHES == before


def test_plain_version_is_conv2d():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 5, 4, 7, generator=g)
    w, b = torch.randn(2, 5, 3, 3, generator=g), torch.randn(2, generator=g)
    assert torch.equal(FH.flow_head_plain(x, w, b),
                       F.conv2d(x, w, b, padding=1))


def _module_heads(net):
    """The decoder's ``_head`` as it ran before: the module's call."""
    return lambda lvl, x: getattr(net, f"predict_flow{lvl}")(x)


@pytest.mark.parametrize("grad", [False, True])
def test_decode_flow_unchanged(net, grad):
    """A PWC-Net forward at 64 x 64 gives the flow of the module path bit
    for bit, without autograd and under it, and both directions of the
    bidirectional pass too; no kernel launches."""
    g = torch.Generator().manual_seed(3)
    im1, im2 = torch.rand(2, 1, 3, 64, 64, generator=g)
    before = dict(kernels.LAUNCHES)
    with torch.set_grad_enabled(grad):
        got = net(im1, im2)
        got_bi = net.bidirectional(im1, im2)
        net._head = _module_heads(net)
        try:
            want = net(im1, im2)
            want_bi = net.bidirectional(im1, im2)
        finally:
            del net._head
    assert (got.grad_fn is not None) == grad
    assert got.shape == (1, 2, 16, 16)
    assert torch.equal(got, want)
    for a, b in zip(got_bi, want_bi):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES == before


def test_decode_gradients_unchanged(net):
    """Under autograd the heads' parameters and the frames get the module
    path's gradients bit for bit."""
    g = torch.Generator().manual_seed(4)
    im1, im2 = torch.rand(2, 1, 3, 64, 64, generator=g)
    cot = torch.randn(1, 2, 16, 16, generator=g)
    leaves = [im1.requires_grad_()] + [
        p for lvl, _ in LEVELS
        for p in getattr(net, f"predict_flow{lvl}").parameters()]
    got = torch.autograd.grad((net(im1, im2) * cot).sum(), leaves)
    net._head = _module_heads(net)
    try:
        want = torch.autograd.grad((net(im1, im2) * cot).sum(), leaves)
    finally:
        del net._head
    assert len(got) == 11
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_autograd_node_gives_the_plain_gradients(monkeypatch):
    """The autograd node that carries K11 on the card gives the plain
    version's gradients bit for bit, the plain forward standing in for the
    kernel; a frozen input gets none."""
    monkeypatch.setattr(FH, "_launch", lambda x, w, b: FH.flow_head_plain(
        x.detach(), w.detach(), b.detach()))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 37, 6, 9, generator=g, requires_grad=True)
    w = torch.randn(2, 37, 3, 3, generator=g, requires_grad=True)
    b = torch.randn(2, generator=g, requires_grad=True)
    out = FH._FlowHead.apply(x, w, b)
    assert type(out.grad_fn).__name__ == "_FlowHeadBackward"
    cot = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad((out * cot).sum(), (x, w, b))
    want = torch.autograd.grad((FH.flow_head_plain(x, w, b) * cot).sum(),
                               (x, w, b))
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    frozen = FH._FlowHead.apply(x.detach(), w, b)
    gw, gb = torch.autograd.grad((frozen * cot).sum(), (w, b))
    assert torch.equal(gw, got[1]) and torch.equal(gb, got[2])


def _bad(case):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 13, 6, 9, generator=g)
    w = torch.randn(2, 13, 3, 3, generator=g)
    b = torch.randn(2, generator=g)
    if case == "x float64":
        x = x.double()
    elif case == "w bfloat16":
        w = w.bfloat16()
    elif case == "b float64":
        b = b.double()
    elif case == "x not contiguous":
        x = torch.randn(2, 13, 9, 6, generator=g).transpose(2, 3)
    elif case == "w not contiguous":
        w = torch.randn(2, 13, 3, 3, generator=g).transpose(2, 3)
    elif case == "3 output channels":
        w = torch.randn(3, 13, 3, 3, generator=g)
    elif case == "kernel 5x5":
        w = torch.randn(2, 13, 5, 5, generator=g)
    elif case == "channels differ":
        x = x[:, :12].contiguous()
    elif case == "b's length":
        b = torch.randn(3, generator=g)
    elif case == "x 3-d":
        x = x[0]
    elif case == "x empty":
        x = x[:0]
    elif case == "w on another device":
        w = w.to("meta")
    elif case == "b on another device":
        b = b.to("meta")
    return x, w, b


@pytest.mark.parametrize("case, error", [
    ("x float64", TypeError), ("w bfloat16", TypeError),
    ("b float64", TypeError), ("x not contiguous", ValueError),
    ("w not contiguous", ValueError), ("3 output channels", ValueError),
    ("kernel 5x5", ValueError), ("channels differ", ValueError),
    ("b's length", ValueError), ("x 3-d", ValueError),
    ("x empty", ValueError), ("w on another device", ValueError),
    ("b on another device", ValueError)])
def test_flow_head_rejects(case, error):
    """The checks run on every device, before the dispatch."""
    x, w, b = _bad(case)
    with pytest.raises(error):
        FH.flow_head(x, w, b)


@pytest.mark.parametrize("cell,n,lvl,h,w", CELL_LEVELS)
def test_plan_follows_the_shape_and_covers_every_channel(cell, n, lvl, h, w):
    """The tile and the split are a pure function of (N, H, W, C, SMs): the
    same on a second call and after the cache is emptied; a tile of 8 or 16
    rows, a split of 1 to 16 blocks, never more than the stages of 8
    channels; the blocks' channel runs cover every channel once, in order,
    each run whole stages but the last."""
    c = C[lvl]
    for sms in (132, 114, 78):
        rows, split = FH.plan(n, h, w, c, sms)
        assert FH.plan(n, h, w, c, sms) == (rows, split)
        saved = dict(FH._PLANS)
        FH._PLANS.clear()
        try:
            assert FH.plan(n, h, w, c, sms) == (rows, split)
        finally:
            FH._PLANS.clear()
            FH._PLANS.update(saved)
        assert rows in (FH.SMALL, FH.LARGE)
        assert 1 <= split <= min(FH.MAX_SPLIT, math.ceil(c / FH.STAGE_C))
        runs = _channel_runs(c, split)
        assert len(runs) == split
        assert [ch for lo, hi in runs for ch in range(lo, hi)] == \
            list(range(c))
        assert all(lo < hi and lo % FH.STAGE_C == 0 for lo, hi in runs)


def test_plan_splits_small_maps_and_not_large_batches():
    """The small levels of a 512 x 320 pair take a cluster; cell 5's level
    2 (batch 80) fills the card unsplit."""
    for lvl in (3, 4, 5, 6):
        assert FH.plan(2, 320 >> lvl, 512 >> lvl, C[lvl], 132)[1] > 1
    assert FH.plan(80, 64, 112, C[2], 132)[1] == 1


@pytest.mark.parametrize("c,split", [(529, 16), (565, 3), (37, 5), (8, 1),
                                     (9, 2), (661, 7)])
def test_channel_runs_cover_a_c_that_does_not_divide(c, split):
    runs = _channel_runs(c, split)
    assert runs[0][0] == 0 and runs[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert all(lo < hi for lo, hi in runs)


def test_state_dict_keys_unchanged(net):
    """The heads keep the reference's names (``predict_flow{lvl}.weight``,
    ``.bias``), so published checkpoints load strictly."""
    sd = net.state_dict()
    for lvl, c in LEVELS:
        assert tuple(sd[f"predict_flow{lvl}.weight"].shape) == (2, c, 3, 3)
        assert tuple(sd[f"predict_flow{lvl}.bias"].shape) == (2,)
    PWCDCNet().load_state_dict(sd, strict=True)


@pytest.mark.parametrize("grad", [False, True])
def test_heads_span_holds_each_head(net, grad):
    """Under a profiler a forward records five ``vfidkr/flow/heads`` spans,
    each inside a ``vfidkr/flow/decoder`` span and holding one head's
    convolution."""
    g = torch.Generator().manual_seed(5)
    im1, im2 = torch.rand(2, 1, 3, 64, 64, generator=g)
    with torch.set_grad_enabled(grad), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net(im1, im2)
    events = prof.events()

    def within(e, s):
        return (s.time_range.start <= e.time_range.start
                and e.time_range.end <= s.time_range.end)

    heads = [e for e in events if e.name == "vfidkr/flow/heads"]
    decoders = [e for e in events if e.name == "vfidkr/flow/decoder"]
    assert len(heads) == 5 and len(decoders) == 5
    assert all(sum(within(h, d) for d in decoders) == 1 for h in heads)
    convs = [e for e in events if e.name == "aten::conv2d"]
    held = [[e for e in convs if within(e, h)] for h in heads]
    assert [len(c) for c in held] == [1] * 5


def test_heads_span_named_by_the_module(monkeypatch):
    spans = []
    real = pwcnet.span

    def spy(name):
        spans.append(name)
        return real(name)

    monkeypatch.setattr(pwcnet, "span", spy)
    m = PWCDCNet()
    with torch.no_grad():
        m(torch.rand(1, 3, 64, 64), torch.rand(1, 3, 64, 64))
    assert spans.count("vfidkr/flow/heads") == 5
    # each head opens inside its level's decoder span, after the dense block
    for i, name in enumerate(spans):
        if name == "vfidkr/flow/heads":
            assert spans[i - 1] == "vfidkr/flow/decoder"
