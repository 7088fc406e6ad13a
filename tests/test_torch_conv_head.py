"""The rectifier's float32 head, ``ops.conv_head.rectify_head``, on the CPU.

On CPU tensors the wrapper runs its plain version, which is the head that
``MultipleBasicBlock.block1`` computed before (bit for bit); K8 itself runs
only on the card (``tests/test_torch_cuda.py``).  Here: the wrapper's checks,
which lane calls it, the module's parameters and the ``vfidkr/rectifier/head``
span.
"""
import pytest
import torch
import torch.nn.functional as F

from vfidkr_torch import kernels
from vfidkr_torch.models import resblock
from vfidkr_torch.models.resblock import MultipleBasicBlock
from vfidkr_torch.ops import conv_head as CH

LANES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _block(c, lane="float32", seed=0):
    m = MultipleBasicBlock(c, 128, generator=torch.Generator().manual_seed(seed),
                           compute_dtype=LANES[lane])
    with torch.no_grad():   # a bias that is not zero, so the sum shows it
        m.block1[0].bias.uniform_(-0.1, 0.1,
                                  generator=torch.Generator().manual_seed(1))
    return m


def _x(c, h=16, w=24, n=1, seed=2):
    return torch.rand(n, c, h, w, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n,c,h,w", [(1, 45, 16, 24), (2, 13, 9, 11),
                                     (1, 437, 8, 12)])
def test_plain_head_is_block1(n, c, h, w):
    """The wrapper on CPU tensors gives ``block1``'s bits (conv, bias, ReLU)
    and launches nothing."""
    m = _block(c)
    x = _x(c, h, w, n)
    before = kernels.LAUNCHES["rectify_head"]
    got = CH.rectify_head(x, m.block1[0].weight, m.block1[0].bias)
    assert torch.equal(got, m.block1(x))
    assert torch.equal(got, F.relu(F.conv2d(
        x, m.block1[0].weight, m.block1[0].bias, padding=3)))
    assert bool((got == 0).any()) and bool((got > 0).any())
    assert kernels.LAUNCHES["rectify_head"] == before


def test_plain_head_gradients_are_block1s():
    """Under autograd the CPU path's gradients are ``block1``'s."""
    m = _block(45)
    x = _x(45).requires_grad_()
    cot = torch.randn(1, 128, 16, 24, generator=torch.Generator().manual_seed(3))
    conv = m.block1[0]
    got = torch.autograd.grad(
        (CH.rectify_head(x, conv.weight, conv.bias) * cot).sum(),
        (x, conv.weight, conv.bias))
    want = torch.autograd.grad((m.block1(x) * cot).sum(),
                               (x, conv.weight, conv.bias))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bad(case):
    m = _block(13)
    x, w, b = _x(13), m.block1[0].weight.detach(), m.block1[0].bias.detach()
    if case == "x float64":
        x = x.double()
    elif case == "w bfloat16":
        w = w.bfloat16()
    elif case == "b float64":
        b = b.double()
    elif case == "x not contiguous":
        x = _x(13, 24, 16).transpose(2, 3)
    elif case == "w not contiguous":
        w = w.transpose(2, 3)
    elif case == "kernel 3x3":
        w = w[:, :, 2:5, 2:5].contiguous()
    elif case == "kernel 5x5":
        w = w[:, :, 1:6, 1:6].contiguous()
    elif case == "64 output channels":
        w, b = w[:64].contiguous(), b[:64].contiguous()
    elif case == "channels differ":
        x = _x(12)
    elif case == "x 3-d":
        x = x[0]
    return x, w, b


@pytest.mark.parametrize("case, error", [
    ("x float64", TypeError), ("w bfloat16", TypeError),
    ("b float64", TypeError), ("x not contiguous", ValueError),
    ("w not contiguous", ValueError), ("kernel 3x3", ValueError),
    ("kernel 5x5", ValueError), ("64 output channels", ValueError),
    ("channels differ", ValueError), ("x 3-d", ValueError)])
def test_wrapper_rejects(case, error):
    """The checks run on every device, before the dispatch."""
    x, w, b = _bad(case)
    with pytest.raises(error):
        CH.rectify_head(x, w, b)


@pytest.mark.parametrize("lane, calls", [("float32", 1), ("bfloat16", 0)])
def test_which_lane_calls_the_wrapper(monkeypatch, lane, calls):
    """The float32 rectifier sends its head through ``rectify_head`` once a
    call; the bf16 lane keeps its own bf16 head and never calls it."""
    seen = []

    def counted(x, w, b):
        seen.append((x.shape, w.shape, b.shape))
        return CH.rectify_head(x, w, b)

    monkeypatch.setattr(resblock, "rectify_head", counted)
    m = _block(45, lane).eval()
    with torch.no_grad():
        m(_x(45))
    assert len(seen) == calls
    if calls:
        assert seen[0] == ((1, 45, 16, 24), (128, 45, 7, 7), (128,))


def test_float32_rectifier_output_unchanged():
    """The float32 rectifier through the wrapper equals its blocks chained
    by hand, as it ran before."""
    m = _block(45).eval()
    x = _x(45)
    with torch.no_grad():
        want = m.block5(m.block4(m.block3(m.block2(m.block1(x)))))
        assert torch.equal(m(x), want)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_state_dict_keys_unchanged(lane):
    """The head's parameters stay ``block1.0.weight`` and ``block1.0.bias``:
    the reference's names, so strict loads still work."""
    m = _block(437, lane)
    keys = list(m.state_dict())
    assert keys[:2] == ["block1.0.weight", "block1.0.bias"]
    assert keys == (["block1.0.weight", "block1.0.bias"]
                    + [f"block{k}.conv{j}.weight" for k in (2, 3, 4)
                       for j in (1, 2)]
                    + ["block5.0.weight", "block5.0.bias"])
    assert tuple(m.state_dict()["block1.0.weight"].shape) == (128, 437, 7, 7)
    m.load_state_dict(_block(437, lane, seed=5).state_dict(), strict=True)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_head_span_recorded(lane):
    """Under a profiler each rectifier call records one
    ``vfidkr/rectifier/head`` span, which holds the head's convolution."""
    m = _block(45, lane).eval()
    x = _x(45)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m(x)
        m(x)
    events = prof.events()
    heads = [e for e in events if e.name == "vfidkr/rectifier/head"]
    assert len(heads) == 2
    convs = [e for e in events if e.name == "aten::conv2d"]
    inside = [e for e in convs if any(
        h.time_range.start <= e.time_range.start
        and e.time_range.end <= h.time_range.end for h in heads)]
    # the head's conv, once a call; the trunk's and block 5's lie outside
    assert len(inside) == 2 and len(convs) > len(inside)


def test_head_span_off_without_profiler(monkeypatch):
    """Without a profiler the span is the shared no-op."""
    from vfidkr_torch.utils import profiling
    spans = []
    real = profiling.span

    def spy(name):
        s = real(name)
        spans.append((name, s))
        return s

    monkeypatch.setattr(resblock, "span", spy)
    with torch.no_grad():
        _block(45)(_x(45))
    assert spans == [("vfidkr/rectifier/head", profiling.OFF)]
