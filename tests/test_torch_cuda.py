"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip without
one.  They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-5 absolute (float32 sums in another order; the scatter's
atomic adds in any order); hit counts exactly; the depth-weighted scatter's
sums, weight sum included, and its average relative to max(1, |plain|).  Gradients: 1e-5 x the
tensor's largest magnitude (at least 1), since the image gradient's atomic
adds pile up at the frame's edge.  The kernels take float32 only, so
``torch.autograd.gradcheck`` (float64) does not apply: the backward kernels
are held to the autograd of the plain forwards.  The bf16 trunk
(``fused_resblocks``) against its plain version: |diff| <= 2^-6 x max(1,
max |plain|), two bf16 ulps of the largest output (the sums run in another
order, a bf16 rounding flips by one ulp now and then, and the chain of six
convs carries the flips on; chip_smoke.py also holds each launch to one
plain conv elementwise).
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

import torch_corr  # noqa: E402  (tests/: K13's shapes and yardstick)
import torch_adacof  # noqa: E402  (tests/: K14's shapes and yardstick)

ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(before):
    """{kernel: launches since ``before``, a copy of ``kernels.LAUNCHES``}
    of the kernels that launched."""
    from vfidkr_torch import kernels
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


def _flow(g, n, h, w, scale):
    flow = (torch.rand(n, 2, h, w, generator=g) * 2 - 1) * scale
    flow[0, :, 1, w - 4] = torch.tensor([3.0, 0.0])          # x2 == W-1
    flow[0, :, 2, 0] = torch.tensor([w / 2, 0.0])            # |fx| == W/2
    flow[-1, :, h - 1, 3] = torch.tensor([0.0, -(h - 1.0)])  # y2 == 0
    return flow


@pytest.mark.parametrize("c", [3, 8, 16, 196])
def test_filter_interpolate_kernel(dev, c):
    """K1 up to 8 channels, K7 (the context warp) beyond; an invalid pixel
    copies all channels."""
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import filter_interpolation as FI
    g = torch.Generator().manual_seed(0)
    n, h, w = 2, 40, 72
    image = torch.rand(n, c, h, w, generator=g).to(dev)
    flow = _flow(g, n, h, w, 20.0).to(dev)
    filt = torch.randn(n, 16, h, w, generator=g).to(dev)
    name = FI.forward_kernel(c)
    assert name == ("filter_interpolate_fwd" if c <= 8
                    else "filter_interpolate_ctx")
    before = dict(kernels.LAUNCHES)
    got = FI.filter_interpolate(image, flow, filt)
    torch.cuda.synchronize()
    assert _launched(before) == {name: 1}
    want = FI.filter_interpolate_plain(image, flow, filt)
    assert (got - want).abs().max().item() <= ATOL
    assert torch.equal(got[0, :, 2, 0], image[0, :, 2, 0])   # |fx| == W/2


def test_flow_project_kernels(dev):
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_projection as FP
    g = torch.Generator().manual_seed(1)
    flow = _flow(g, 2, 40, 72, 12.0).to(dev)
    before = dict(kernels.LAUNCHES)
    acc = FP.scatter4(flow)
    out = FP.finalize(acc)
    torch.cuda.synchronize()
    for name in ("flow_project_scatter", "flow_project_finalize"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    acc_p = FP.scatter4_plain(flow)
    assert torch.equal(acc[:, 2], acc_p[:, 2])
    cnt = acc_p[:, 2:].clamp(min=1)
    assert (acc[:, :2] / cnt - acc_p[:, :2] / cnt).abs().max().item() <= ATOL
    assert (out - FP.finalize_plain(acc)).abs().max().item() <= ATOL


def test_depth_flow_project_kernels(dev):
    """K2 with a weight, then K3, against the plain versions, on a smooth
    flow (a random one sums flows of both signs into one cell, and the
    relative error of a sum near 0 is unbounded)."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_projection as FP
    g = torch.Generator().manual_seed(6)
    n, h, w = 2, 40, 72
    coarse = (torch.rand(n, 2, 3, 5, generator=g) * 2 - 1) * 12
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=True).to(dev)
    depth_inv = (1e-6 + torch.exp(-(torch.rand(n, h, w, generator=g) * 4 - 1))
                 ).to(dev)
    before = dict(kernels.LAUNCHES)
    acc = FP.scatter4(flow, depth_inv)
    out = FP.depth_flow_project(flow, depth_inv, hole_fill=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flow_project_scatter"] == (
        before["flow_project_scatter"] + 2)
    assert kernels.LAUNCHES["flow_project_finalize"] == (
        before["flow_project_finalize"] + 1)
    acc_p = FP.scatter4_plain(flow, depth_inv)
    assert bool((acc_p[:, 2] <= 0).any())                   # holes to fill
    for got, want in ((acc, acc_p), (FP.finalize(acc), FP.finalize_plain(acc)),
                      (out, FP.finalize_plain(acc_p))):
        assert ((got - want).abs() / want.abs().clamp(min=1)).max() <= ATOL


@pytest.mark.parametrize("kind, c, n, h, w", [
    ("discontinuity", 196, 2, 64, 96),      # tiles past the staging box
    ("near-uniform", 196, 2, 64, 96),       # the paths' move: every tile staged
    ("smooth", 196, 2, 37, 75),             # ragged: partial tiles, 4-byte copies
    ("smooth", 196, 2, 37, 76),             # ragged: partial tiles, 16-byte copies
    ("smooth", 9, 2, 37, 75),               # one channel range, short chunks
    ("smooth", 37, 2, 64, 96),
    ("smooth", 200, 1, 40, 72),             # four ranges of 50 channels
])
def test_filter_interpolate_ctx_geometry(dev, kind, c, n, h, w):
    """K7's staged and direct-gather tiles against the plain version, with
    the direct-gather tile count: |diff| <= 1e-5 x max(1, |plain|)."""
    import numpy as np
    import torch_geometry as geo
    from vfidkr_torch.ops import filter_interpolation as FI
    rng = np.random.RandomState(3)
    flow = {"discontinuity": lambda: geo.discontinuous_flow(rng, n, h, w),
            "near-uniform": lambda: geo.smooth_flow(rng, n, h, w, 0.5,
                                                    (5.3, -3.1)),
            "smooth": lambda: geo.smooth_flow(rng, n, h, w, 8.0)}[kind]()
    image, flow, filt = (torch.from_numpy(a).to(dev)
                         for a in geo.k7_inputs(rng, n, c, h, w, flow))
    got, direct = FI.filter_interpolate_ctx_counted(image, flow, filt)
    want = FI.filter_interpolate_plain(image, flow, filt)
    assert ((got - want).abs() / want.abs().clamp(min=1)).max() <= ATOL
    assert torch.equal(got, FI.filter_interpolate(image, flow, filt))
    assert (direct > 0) == (kind == "discontinuity")


@pytest.mark.parametrize("layout, n, h, w", [
    ("edge band", 2, 64, 96), ("edge band", 1, 70, 75),
    ("word-crossing runs", 2, 64, 128), ("word-crossing runs", 1, 70, 140),
    ("all holes", 2, 40, 72)])
def test_flow_project_finalize_layouts(dev, layout, n, h, w):
    """K3's word scans on hole layouts: equal to the plain version bit for
    bit (the same IEEE divisions, the neighbours summed in the same
    order)."""
    import numpy as np
    import torch_geometry as geo
    from vfidkr_torch.ops import flow_projection as FP
    rng = np.random.RandomState(4)
    if layout == "edge band":
        acc = FP.scatter4(torch.from_numpy(geo.edge_band_flow(n, h, w)).to(dev))
        assert bool((acc[:, 2, :, :24] <= 0).all())
    elif layout == "word-crossing runs":
        acc = torch.from_numpy(geo.word_crossing_sums(rng, n, h, w)).to(dev)
    else:
        acc = torch.zeros(n, 3, h, w, device=dev)
    got = FP.finalize(acc)
    assert torch.equal(got, FP.finalize_plain(acc))
    if layout == "all holes":
        assert not bool(got.any())


def _scatter_flow(rng, kind, n, h, w):
    import torch_geometry as geo
    return {"converging": lambda: geo.converging_flow(n, h, w, 0.75),
            "jump": lambda: geo.scatter_jump_flow(rng, n, h, w),
            "border landings": lambda: geo.border_landing_flow(rng, n, h, w),
            "near-uniform": lambda: geo.smooth_flow(rng, n, h, w, 0.5,
                                                    (5.3, -3.1)),
            "smooth": lambda: geo.smooth_flow(rng, n, h, w, 8.0)}[kind]()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "depth-weighted"])
@pytest.mark.parametrize("kind, n, h, w", [
    ("converging", 2, 64, 64),              # several sources a cell
    ("jump", 2, 64, 128),                   # tiles past the shared-memory box
    ("border landings", 2, 64, 64),         # the double add
    ("near-uniform", 6, 64, 96),            # the paths' move, N = 6
    ("smooth", 2, 37, 75),                  # ragged: 4-byte flush
    ("smooth", 2, 37, 76),                  # ragged: 16-byte flush
])
def test_flow_project_scatter_geometry(dev, kind, n, h, w, weighted):
    """K2's shared-memory boxes and direct adds against the plain version:
    the count equal bit for bit, the sums (the weight sum too) within 1e-5
    x max(1, |plain|); only the jump takes direct-add tiles."""
    import numpy as np
    import torch_geometry as geo
    from vfidkr_torch.ops import flow_projection as FP
    rng = np.random.RandomState(5)
    flow = torch.from_numpy(_scatter_flow(rng, kind, n, h, w)).to(dev)
    weight = (torch.from_numpy(geo.depth_weight(rng, n, h, w)).to(dev)
              if weighted else None)
    got, direct = FP.scatter4_counted(flow, weight)
    want = FP.scatter4_plain(flow, weight)
    if not weighted:
        assert torch.equal(got[:, 2], want[:, 2])
    assert ((got - want).abs() / want.abs().clamp(min=1)).max() <= ATOL
    assert (direct > 0) == (kind == "jump")


@pytest.mark.parametrize("kind, n, c, h, w", [
    ("edge flows", 2, 3, 48, 64),           # |f| == W/2, H/2; inclusive edges
    ("edge flows", 2, 1, 48, 64),
    ("smooth", 6, 3, 64, 96),               # N = 6
    ("smooth", 6, 3, 256, 448),             # the train steps' full frame
    ("smooth", 2, 8, 40, 72),
    ("smooth", 2, 1, 37, 75),               # ragged: partial tiles
    ("smooth", 2, 3, 37, 76),
    ("smooth", 2, 8, 37, 75),
])
def test_filter_interpolate_fwd_geometry(dev, kind, n, c, h, w):
    """K1 against its plain version, |diff| <= 1e-5 x max(1, |plain|); an
    invalid pixel copies its source bit for bit."""
    import numpy as np
    import torch_geometry as geo
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import filter_interpolation as FI
    rng = np.random.RandomState(6)
    flow = (geo.warp_edge_flow(rng, n, h, w) if kind == "edge flows"
            else geo.smooth_flow(rng, n, h, w, 8.0))
    image, flow, filt = (torch.from_numpy(a).to(dev)
                         for a in geo.k7_inputs(rng, n, c, h, w, flow))
    before = kernels.LAUNCHES["filter_interpolate_fwd"]
    got = FI.filter_interpolate(image, flow, filt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["filter_interpolate_fwd"] == before + 1
    want = FI.filter_interpolate_plain(image, flow, filt)
    assert ((got - want).abs() / want.abs().clamp(min=1)).max() <= ATOL
    fx, fy = flow[:, 0], flow[:, 1]
    x2 = torch.arange(w, device=dev) + fx
    y2 = torch.arange(h, device=dev).view(h, 1) + fy
    invalid = ~((x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
                & (fx.abs() < w / 2) & (fy.abs() < h / 2))
    assert bool(invalid.any())
    mask = invalid.unsqueeze(1).expand_as(got)
    assert torch.equal(got[mask], image[mask])


def test_kernels_reject_bad_inputs(dev):
    from vfidkr_torch.ops import filter_interpolation as FI
    from vfidkr_torch.ops import flow_projection as FP
    image = torch.rand(1, 3, 8, 8, device=dev)
    flow = torch.zeros(1, 2, 8, 8, device=dev)
    filt = torch.rand(1, 16, 8, 8, device=dev)
    with pytest.raises(TypeError):
        FI.filter_interpolate(image.double(), flow, filt)
    with pytest.raises(ValueError, match="contiguous"):
        FP.scatter4(flow.transpose(2, 3))


def test_dain_cuda_matches_cpu(dev):
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN
    g = torch.Generator().manual_seed(2)
    model = DAIN(generator=g).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.37, -0.21]))
    i0 = torch.rand(1, 3, 64, 128, generator=g)
    i2 = torch.rand(1, 3, 64, 128, generator=g)
    cpu = copy.deepcopy(model)
    gpu = model.to(dev)
    kernels.reset_launches()
    with torch.inference_mode():
        got = gpu(i0.to(dev), i2.to(dev))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {"filter_interpolate_fwd": 1,
                                    "flow_project_scatter": 1,
                                    "flow_project_finalize": 1,
                                    "filter_interpolate_bwd": 0,
                                    "flow_project_scatter_bwd": 0,
                                    "filter_interpolate_ctx": 0,
                                    "fused_resblocks": 0,
                                    "depth_flow_project_bwd": 0,
                                    "rectify_head": 1, "sepconv_pair": 0,
                                    "dense_conv": 25, "flow_head": 5,
                                    "softmax_splat": 0,
                                    "correlation": 5, "correlation_bwd": 0,
                                    "adacof": 0}
        want = cpu(i0, i2)
    for key, atol in (("offsets", 1e-4), ("outputs", 2e-4)):
        for a, b in zip(got[key], want[key]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=atol)


def test_record_launches_keeps_kernels_only(dev):
    """One float32 DAIN eval forward inside ``record_launches``: the records
    hold the launches of ``kernels.KERNELS`` alone (K1-K3 once each), while
    ``kernels.LAUNCHES`` counts K8 once, K10 25 times, K11 and K13 5 times
    besides."""
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN
    g = torch.Generator().manual_seed(3)
    model = DAIN(generator=g, init_unused=False).eval().to(dev)
    i0, i2 = torch.rand(2, 1, 3, 64, 128, generator=g).to(dev)
    kernels.reset_launches()
    with torch.inference_mode(), kernels.record_launches() as records:
        model(i0, i2)
    torch.cuda.synchronize()
    names = sorted(name for name, _ in records)
    assert names == ["filter_interpolate_fwd", "flow_project_finalize",
                     "flow_project_scatter"]
    assert {n: names.count(n) for n in kernels.KERNELS} == {
        n: kernels.LAUNCHES[n] for n in kernels.KERNELS}
    assert {n: kernels.LAUNCHES[n] for n in kernels.UNRECORDED} == {
        "rectify_head": 1, "sepconv_pair": 0, "dense_conv": 25,
        "flow_head": 5, "softmax_splat": 0,
        "correlation": 5, "correlation_bwd": 0,
        "adacof": 0}


def _grads_close(name, got, want):
    tol = 1e-5 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("c,need_image", [(1, True), (3, True), (16, True),
                                          (3, False)])
def test_filter_interpolate_bwd_kernel(dev, c, need_image):
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import filter_interpolation as FI
    g = torch.Generator().manual_seed(3)
    n, h, w = 2, 40, 72
    image = torch.rand(n, c, h, w, generator=g).to(dev)
    flow = _flow(g, n, h, w, 20.0).to(dev)
    flow[0, :, 5, w - 9] = torch.tensor([8.0, 0.0], device=dev)  # x2 == W-1
    filt = torch.randn(n, 16, h, w, generator=g).to(dev)
    cot = torch.randn(n, c, h, w, generator=g).to(dev)

    def grads(fn):
        ins = [image.clone().requires_grad_(need_image),
               flow.clone().requires_grad_(), filt.clone().requires_grad_()]
        fn(*ins).backward(cot)
        return [t.grad for t in ins]

    before = dict(kernels.LAUNCHES)
    got = grads(FI.filter_interpolate)
    torch.cuda.synchronize()
    for name in (FI.forward_kernel(c), "filter_interpolate_bwd"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    want = grads(FI.filter_interpolate_plain)
    if not need_image:
        assert got[0] is None and want[0] is None
    for name, a, b in zip(("image", "flow", "filt"), got, want):
        if b is not None:
            _grads_close(name, a, b)


# K6's inputs, (N, H, W): random and smooth flows, landings on the last row
# and column, tests/torch_geometry.py's flows (several pixels a cell, a jump,
# the border, ragged frames), and the paths' move at the train steps' N = 6
K6_CASES = {"random": (2, 40, 72), "smooth": (2, 40, 72),
            "border": (2, 40, 72), "converging": (2, 64, 64),
            "jump": (2, 64, 128), "border landings": (2, 64, 64),
            "ragged 37x75": (2, 37, 75), "ragged 37x76": (2, 37, 76),
            "N=6": (6, 64, 96), "N=6 full frame": (6, 256, 448)}


def _k6_flow(g, case):
    """The flow of K6's ``case``: random up to +-12 px, smooth up to +-12
    with a patch off the frame, landings on and beyond the last row and
    column (two of the four cells are one, added to and read back twice),
    or tests/torch_geometry.py's (N = 6: the paths' move)."""
    import numpy as np
    import torch.nn.functional as F
    n, h, w = K6_CASES[case]
    if case == "random":
        return _flow(g, n, h, w, 12.0)
    if case == "smooth":
        coarse = (torch.rand(n, 2, 3, 5, generator=g) * 2 - 1) * 12
        flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=True)
        flow[0, 0, 4:8, 2:6] = -30.0                      # off the frame
        return flow
    if case == "border":
        flow = torch.zeros(n, 2, h, w)
        flow[:, 1] = 2.25
        flow[:, 1, h - 1] = 0.0
        flow[:, 0, :, w - 1] = 0.0
        flow[1, 0, 3, w - 2] = 1.0
        return flow
    kind = {"ragged": "smooth", "N=6": "near-uniform"}.get(
        case.split(" ")[0], case)
    return torch.from_numpy(_scatter_flow(np.random.RandomState(5), kind, n,
                                          h, w))


@pytest.mark.parametrize("case", [c for c in K6_CASES if c != "smooth"])
def test_flow_project_scatter_bwd_kernel(dev, case):
    """K6 at C = 2 against the autograd of the plain scatter, through
    ``scatter4``'s autograd Function (one launch; a second gives the same
    bits: no atomics)."""
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_projection as FP
    g = torch.Generator().manual_seed(4)
    n, h, w = K6_CASES[case]
    flow = _k6_flow(g, case).to(dev)
    cot = torch.randn(n, 3, h, w, generator=g).to(dev)
    out_cot = torch.randn(n, 2, h, w, generator=g).to(dev)

    def grads(fn, c):
        f = flow.clone().requires_grad_()
        fn(f).backward(c)
        return f.grad

    before = kernels.LAUNCHES["flow_project_scatter_bwd"]
    got = grads(FP.scatter4, cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flow_project_scatter_bwd"] == before + 1
    _grads_close("scatter4", got, grads(FP.scatter4_plain, cot))
    assert torch.equal(grads(FP.scatter4, cot), got)
    proj = lambda f: FP.flow_project(f, hole_fill=False)
    want = grads(lambda f: FP._count_average(FP.scatter4_plain(f)), out_cot)
    _grads_close("flow_project", grads(proj, out_cot), want)


def test_dain_train_step_cuda_matches_cpu(dev):
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN
    from vfidkr_torch.models.dain import VESTIGIAL
    from vfidkr_torch.training import TrainConfig, make_optimizer, train_step
    g = torch.Generator().manual_seed(5)
    model = DAIN(generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.37, -0.21]))
    batch = {k: torch.rand(1, 3, 64, 128, generator=g)
             for k in ("x0", "x1", "y")}
    cpu = copy.deepcopy(model)
    gpu = model.to(dev)
    config = TrainConfig()
    kernels.reset_launches()
    got = train_step(gpu, make_optimizer(gpu, config),
                     {k: v.to(dev) for k, v in batch.items()}, config)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"filter_interpolate_fwd": 1,
                                "flow_project_scatter": 1,
                                "flow_project_finalize": 0,
                                "filter_interpolate_bwd": 1,
                                "flow_project_scatter_bwd": 1,
                                "filter_interpolate_ctx": 0,
                                "fused_resblocks": 0,
                                "depth_flow_project_bwd": 0,
                                "rectify_head": 1, "sepconv_pair": 0,
                                "dense_conv": 25, "flow_head": 5,
                                "softmax_splat": 0,
                                "correlation": 5, "correlation_bwd": 5,
                                "adacof": 0}
    want = train_step(cpu, make_optimizer(cpu, config), batch, config)
    torch.testing.assert_close(got["total"].cpu(), want["total"], rtol=1e-4,
                               atol=0)
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        if b.grad is None:
            # the vestigial children (init_unused) take no part in the step
            assert a.grad is None and name.startswith(VESTIGIAL), name
            continue
        scale = max(a.grad.abs().max().item(), b.grad.abs().max().item(),
                    1e-12)
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=5e-3,
                                   atol=5e-3 * scale, msg=name)


def test_dain_slowmotion_cuda_matches_cpu(dev):
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAINSlowMotion
    g = torch.Generator().manual_seed(7)
    model = DAINSlowMotion(timestep=0.25, generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.37, -0.21]))
    i0 = torch.rand(1, 3, 64, 128, generator=g)
    i2 = torch.rand(1, 3, 64, 128, generator=g)
    cpu = copy.deepcopy(model)
    gpu = model.to(dev)
    kernels.reset_launches()
    with torch.inference_mode():
        got = gpu(i0.to(dev), i2.to(dev))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {"filter_interpolate_fwd": 3,
                                    "flow_project_scatter": 3,
                                    "flow_project_finalize": 3,
                                    "filter_interpolate_bwd": 0,
                                    "flow_project_scatter_bwd": 0,
                                    "filter_interpolate_ctx": 3,
                                    "fused_resblocks": 0,
                                    "depth_flow_project_bwd": 0,
                                    "rectify_head": 3, "sepconv_pair": 0,
                                    "dense_conv": 25, "flow_head": 5,
                                    "softmax_splat": 0,
                                    "correlation": 5, "correlation_bwd": 0,
                                    "adacof": 0}
        want = cpu(i0, i2)
    for a, b in zip(got["offsets"], want["offsets"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
    for frames_a, frames_b in zip(got["outputs"], want["outputs"]):
        for a, b in zip(frames_a, frames_b):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=2e-4)


def _depth_bwd_inputs(g, case):
    """flow, depth, the cotangent g and the forward's cnt and unfilled out,
    on the flow of K6's ``case``."""
    from vfidkr_torch.ops import flow_projection as FP
    n, h, w = K6_CASES[case]
    flow = _k6_flow(g, case)
    depth = 1e-6 + torch.exp(-(torch.rand(n, h, w, generator=g) * 4 - 1))
    cot = torch.randn(n, 2, h, w, generator=g)
    acc = FP.scatter4_plain(flow, depth)
    return flow, depth, cot, acc[:, 2].contiguous(), FP._count_average(acc)


@pytest.mark.parametrize("need_depth", [True, False])
@pytest.mark.parametrize("case", [c for c in K6_CASES if c != "random"])
def test_depth_flow_project_bwd_kernel(dev, case, need_depth):
    """The depth projection's backward kernel against its plain version,
    with the depth gradient and with it NULL (a second launch gives the
    same bits: no atomics); and through the autograd Function of
    ``depth_flow_project``, one launch a backward."""
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_projection as FP
    g = torch.Generator().manual_seed(8)
    ins = [t.to(dev) for t in _depth_bwd_inputs(g, case)]
    before = kernels.LAUNCHES["depth_flow_project_bwd"]
    gflow, gdepth = FP.depth_flow_project_bwd(*ins, need_depth=need_depth)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["depth_flow_project_bwd"] == before + 1
    want_flow, want_depth = FP.depth_flow_project_bwd_plain(
        *ins, need_depth=need_depth)
    _grads_close("gflow", gflow, want_flow)
    if need_depth:
        _grads_close("gdepth", gdepth, want_depth)
    else:
        assert gdepth is None and want_depth is None
    again = FP.depth_flow_project_bwd(*ins, need_depth=need_depth)
    assert torch.equal(again[0], gflow)
    assert again[1] is None if gdepth is None else torch.equal(again[1],
                                                               gdepth)

    flow, depth, cot = ins[:3]
    f = flow.clone().requires_grad_()
    d = depth.clone().requires_grad_(need_depth)
    FP.depth_flow_project(f, d, hole_fill=case == "smooth").backward(cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["depth_flow_project_bwd"] == before + 3
    _grads_close("gflow via autograd", f.grad, want_flow)
    if need_depth:
        _grads_close("gdepth via autograd", d.grad, want_depth)


def test_depth_flow_project_bwd_rejects_bad_inputs(dev):
    from vfidkr_torch.ops import flow_projection as FP
    g = torch.Generator().manual_seed(9)
    flow, depth, cot, cnt, out = (t[:1, ..., :8, :8].contiguous().to(dev)
                                  for t in _depth_bwd_inputs(g, "smooth"))
    with pytest.raises(TypeError):
        FP.depth_flow_project_bwd(flow.double(), depth, cot, cnt, out)
    with pytest.raises(ValueError, match="contiguous"):
        FP.depth_flow_project_bwd(flow, depth, cot.transpose(2, 3), cnt, out)
    with pytest.raises(ValueError, match="cnt must be"):
        FP.depth_flow_project_bwd(flow, depth, cot, cnt[..., :4].contiguous(),
                                  out)


def test_dain_slowmotion_train_step_cuda_matches_cpu(dev):
    """One DAINSlowMotion(0.5) train step: K1, K7, K2, K5 and the depth
    projection's backward once each, no hole fill; the context and depth
    nets frozen; the loss and each grouped gradient leaf held to the same
    step on the CPU.  The weights are tamed as chip_smoke.py tames them
    (biases jittered, a (5.3, -3.1) px flow bias) and the frames are a
    smooth scene moved by (5, -3) px: on random-noise frames a 1e-5 change
    of the input moves some PWC-Net leaves past this tolerance on the CPU
    alone (landings that cross a cell boundary)."""
    import copy
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAINSlowMotion
    from vfidkr_torch.training import TrainConfig, make_optimizer, train_step
    g = torch.Generator().manual_seed(10)
    model = DAINSlowMotion(0.5, generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.mul_(0.5)
            if name.endswith("bias"):
                p.add_((torch.rand(p.shape, generator=g) - 0.5) * 0.02)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.53, -0.31]))
    h, w = 64, 128
    scene = F.interpolate(torch.rand(1, 3, h // 16 + 1, w // 16 + 1,
                                     generator=g),
                          size=(h + 12, w + 12), mode="bicubic",
                          align_corners=False).clamp(0, 1)
    crop = lambda dx, dy: torch.round(
        scene[:, :, 6 + dy:6 + dy + h, 6 + dx:6 + dx + w] * 255) / 255
    batch = {"x0": crop(-5, 3), "x1": crop(5, -3), "y": crop(0, 0)}
    cpu = copy.deepcopy(model)
    gpu = model.to(dev)
    frozen = {k: v.clone() for k, v in gpu.state_dict().items()
              if k.startswith(("ctxNet", "depthNet"))}
    config = TrainConfig()
    kernels.reset_launches()
    got = train_step(gpu, make_optimizer(gpu, config),
                     {k: v.to(dev) for k, v in batch.items()}, config)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"filter_interpolate_fwd": 1,
                                "flow_project_scatter": 1,
                                "flow_project_finalize": 0,
                                "filter_interpolate_bwd": 1,
                                "flow_project_scatter_bwd": 0,
                                "filter_interpolate_ctx": 1,
                                "fused_resblocks": 0,
                                "depth_flow_project_bwd": 1,
                                "rectify_head": 1, "sepconv_pair": 0,
                                "dense_conv": 25, "flow_head": 5,
                                "softmax_splat": 0,
                                "correlation": 5, "correlation_bwd": 5,
                                "adacof": 0}
    for k, v in gpu.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k
    want = train_step(cpu, make_optimizer(cpu, config), batch, config)
    torch.testing.assert_close(got["total"].cpu(), want["total"], rtol=1e-4,
                               atol=0)
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        if b.grad is None:
            assert a.grad is None and name.startswith(("ctxNet", "depthNet"))
            continue
        scale = max(a.grad.abs().max().item(), b.grad.abs().max().item(),
                    1e-12)
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=5e-3,
                                   atol=5e-3 * scale, msg=name)


def _trunk_inputs(g, n, h, w):
    """A bf16 activation as block 1's ReLU leaves it and six conv weights
    at the rectifier's init (normal, std sqrt(2 / (9 * 128)))."""
    x = torch.relu(torch.randn(n, 128, h, w, generator=g)).bfloat16()
    w6 = (torch.randn(6, 128, 128, 3, 3, generator=g)
          * (2.0 / (9 * 128)) ** 0.5).bfloat16()
    return x, w6


@pytest.mark.parametrize("n,h,w,layout", [
    (1, 64, 128, "channels_last"), (2, 37, 75, "channels_last"),
    (1, 5, 9, "channels_last"), (3, 16, 40, "channels_last"),
    (2, 37, 75, "nchw")])
def test_fused_resblocks_kernel(dev, n, h, w, layout):
    """K4 six times a call: ragged tile edges (37 x 75), a frame narrower
    than one 4 x 64 tile (5 x 9), N = 3, and an NCHW-contiguous input, which
    the wrapper converts; the result is channels-last."""
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import rectify
    x, w6 = (t.to(dev) for t in _trunk_inputs(torch.Generator().manual_seed(8),
                                              n, h, w))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    before = kernels.LAUNCHES["fused_resblocks"]
    got = rectify.fused_resblocks(x, w6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_resblocks"] == before + 6
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = rectify.fused_resblocks_plain(x, w6).float()
    scale = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert scale > 4.0 and err <= 2.0 ** -6 * scale, (err, scale)


def test_fused_resblocks_in_place_residual(dev):
    """conv2 with its residual aliasing its output (as the wrapper runs it)
    gives the bits of the same launch into a separate buffer, and one launch
    matches a plain conv elementwise within 2^-6 x max(1, |plain|)."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import rectify
    x, w6 = (t.to(dev) for t in _trunk_inputs(torch.Generator().manual_seed(10),
                                              2, 37, 75))
    x = x.contiguous(memory_format=torch.channels_last)
    res = torch.relu(torch.randn(x.shape, generator=torch.Generator()
                                 .manual_seed(11))).bfloat16().to(dev)
    res = res.contiguous(memory_format=torch.channels_last)
    taps = rectify.pack_trunk_weights(w6)
    n, _, h, w = x.shape
    separate = torch.empty_like(x)
    kernels.launch("fused_resblocks", x, taps[1], res, separate, n, h, w)
    aliased = res.clone()
    kernels.launch("fused_resblocks", x, taps[1], aliased, aliased, n, h, w)
    torch.cuda.synchronize()
    assert torch.equal(separate, aliased)
    want = F.relu(F.conv2d(x.float(), w6[1].float(), padding=1)
                  + res.float()).bfloat16().float()
    err = ((separate.float() - want).abs() / want.abs().clamp(min=1)).max()
    assert err.item() <= 2.0 ** -6


def test_fused_resblocks_rejects_grad_and_float32(dev):
    from vfidkr_torch.ops import rectify
    x, w6 = (t.to(dev) for t in _trunk_inputs(torch.Generator().manual_seed(9),
                                              1, 8, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        rectify.fused_resblocks(x.float().requires_grad_(), w6)
    with pytest.raises(TypeError, match="bfloat16"):
        rectify.fused_resblocks(x.float(), w6)
    with pytest.raises(TypeError, match="bfloat16"):
        rectify.fused_resblocks(x, w6.float())
    with pytest.raises(ValueError, match="CUDA"):
        rectify.fused_resblocks(x, w6.cpu())


def test_dain_bf16_launches_fused_resblocks(dev):
    """One bf16 DAIN forward: K1-K3 once, K4 six times (one rectifier call);
    the outputs finite and near the float32 lane's (chip_smoke.py's bounds
    on the mean and max |diff|)."""
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN
    g = torch.Generator().manual_seed(2)
    f32 = DAIN(generator=g).eval()
    with torch.no_grad():
        for p in f32.parameters():
            p.mul_(0.5)
    bf16 = DAIN(compute_dtype="bfloat16")
    bf16.load_state_dict(f32.state_dict())
    i0 = torch.rand(1, 3, 64, 128, generator=g).to(dev)
    i2 = torch.rand(1, 3, 64, 128, generator=g).to(dev)
    f32, bf16 = f32.to(dev), bf16.to(dev)
    with torch.inference_mode():
        want = f32(i0, i2)
        kernels.reset_launches()
        got = bf16(i0, i2)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"filter_interpolate_fwd": 1,
                                "flow_project_scatter": 1,
                                "flow_project_finalize": 1,
                                "filter_interpolate_bwd": 0,
                                "flow_project_scatter_bwd": 0,
                                "filter_interpolate_ctx": 0,
                                "fused_resblocks": 6,
                                "depth_flow_project_bwd": 0,
                                "rectify_head": 0, "sepconv_pair": 0,
                                "dense_conv": 25, "flow_head": 5,
                                "softmax_splat": 0,
                                "correlation": 5, "correlation_bwd": 0,
                                "adacof": 0}
    for a, b in zip(got["outputs"], want["outputs"]):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        d = (a - b).abs()
        assert d.mean().item() <= 0.02 and d.max().item() <= 0.25


# K8, the float32 rectifier head: each value against float64, its error over
# the float64 sum of |x||w| + |b| (the scale a float32 sum of those terms
# rounds within).  Float32 sums read 2.6e-7 to 4.2e-7 at these shapes; TF32
# products would read 1e-4 and more.
HEAD_TOL = 2e-6


def _head_inputs(n, c, h, w, seed=12):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, c, h, w, generator=g) * 2 - 1
    wt = torch.randn(128, c, 7, 7, generator=g) * (2.0 / (49 * c)) ** 0.5
    b = torch.randn(128, generator=g) * 0.01
    return x, wt, b


@pytest.mark.parametrize("n,c,h,w", [
    (1, 45, 320, 512), (3, 45, 256, 448), (1, 437, 768, 1344),
    (1, 13, 64, 192), (2, 5, 37, 75)])
def test_rectify_head_kernel(dev, n, c, h, w):
    """K8 at DAIN's head (C = 45, cells 1 and 3), the slow-motion head
    (C = 437 at 1344 x 768), C = 13 and a frame off the 8 x 32 tile
    (37 x 75, W % 4 != 0); two launches give the same bits."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import conv_head as CH
    x, wt, b = (t.to(dev) for t in _head_inputs(n, c, h, w))
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = CH.rectify_head(x, wt, b)
        again = CH.rectify_head(x, wt, b)
    torch.cuda.synchronize()
    assert _launched(before) == {"rectify_head": 2}
    assert got.shape == (n, 128, h, w) and got.is_contiguous()
    assert torch.equal(got, again)
    xd, wd, bd = x.double(), wt.double(), b.double()
    want = F.relu(F.conv2d(xd, wd, bd, padding=3))
    scale = F.conv2d(xd.abs(), wd.abs(), bd.abs(), padding=3)
    err = ((got.double() - want).abs() / scale).max().item()
    assert err <= HEAD_TOL, err
    assert bool((got == 0).any()) and bool((got > 0).any())


def test_rectifier_launches_rectify_head_once(dev):
    """One float32 rectifier call launches K8 once, with no grad and under
    autograd, and no other kernel; its output is the CPU run's within 1e-5
    x max(1, max |CPU|)."""
    from vfidkr_torch import kernels
    from vfidkr_torch.models.resblock import MultipleBasicBlock
    cpu = MultipleBasicBlock(45, 128,
                             generator=torch.Generator().manual_seed(13))
    x = torch.rand(2, 45, 64, 128, generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        want = cpu(x)
    m = MultipleBasicBlock(45, 128).to(dev)
    m.load_state_dict(cpu.state_dict())
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = m(x.to(dev))
    torch.cuda.synchronize()
    assert _launched(before) == {"rectify_head": 1}
    out = m(x.to(dev).requires_grad_())
    out.sum().backward()
    torch.cuda.synchronize()
    assert _launched(before) == {"rectify_head": 2}
    assert m.block1[0].weight.grad is not None
    err = (got.cpu() - want).abs().max().item()
    assert err <= ATOL * max(1.0, want.abs().max().item()), err


def test_rectify_head_gradients_match_cudnn(dev):
    """Under autograd K8's Function gives the input, weight and bias
    gradients of cuDNN's autograd of ``relu(conv2d)`` within 1e-5 of each
    gradient's largest magnitude: its backward is the same
    ``threshold_backward`` and ``convolution_backward`` on the saved
    tensors.  (At this seed no pre-activation lies within rounding of 0, so
    both take the same ReLU mask, checked first.)  A frozen input gets no
    gradient."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import conv_head as CH
    x, wt, b = (t.to(dev) for t in _head_inputs(2, 45, 64, 96, seed=15))
    cot = torch.randn(2, 128, 64, 96,
                      generator=torch.Generator().manual_seed(16)).to(dev)
    leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
    ref = [t.clone().requires_grad_() for t in (x, wt, b)]
    before = dict(kernels.LAUNCHES)
    out = CH.rectify_head(*leaves)
    assert _launched(before) == {"rectify_head": 1}
    assert type(out.grad_fn).__name__ == "_RectifyHeadBackward"
    want = F.relu(F.conv2d(ref[0], ref[1], ref[2], padding=3))
    assert torch.equal(out > 0, want > 0)
    got_g = torch.autograd.grad((out * cot).sum(), leaves)
    want_g = torch.autograd.grad((want * cot).sum(), ref)
    for name, a, e in zip("xwb", got_g, want_g):
        err = (a - e).abs().max().item()
        assert err <= 1e-5 * e.abs().max().item(), (name, err)
    frozen = CH.rectify_head(x, *leaves[1:])
    gw, gb = torch.autograd.grad((frozen * cot).sum(), leaves[1:])
    assert torch.allclose(gw, got_g[1], rtol=0, atol=1e-5 * gw.abs().max().item())


def test_rectify_head_rejects_bad_inputs(dev):
    from vfidkr_torch.ops import conv_head as CH
    x, wt, b = (t.to(dev) for t in _head_inputs(1, 13, 16, 16))
    with pytest.raises(TypeError, match="float32"):
        CH.rectify_head(x.half(), wt, b)
    with pytest.raises(ValueError, match="contiguous"):
        CH.rectify_head(x.transpose(2, 3), wt, b)
    with pytest.raises(ValueError, match="7x7"):
        CH.rectify_head(x, wt[:, :, :3, :3].contiguous(), b)
    with pytest.raises(ValueError, match="different devices"):
        CH.rectify_head(x, wt.cpu(), b)


# K10, PWC-Net's dense-block convs: each value against float64, its error over
# the float64 sum of |x||w| + |b| (the scale a float32 sum of those terms
# rounds within), as K8's.
DENSE_TOL = 2e-6
_DENSE_OD = {6: 81, 5: 213, 4: 181, 3: 149, 2: 117}
# each level's map of a bidirectional decode (batch 2): cells 1 and 4 (a
# 512 x 320 pair) and cell 2 (1344 x 768)
_DENSE_LEVELS = ([("cells 1, 4", 2, lvl, 320 >> lvl, 512 >> lvl)
                  for lvl in (2, 3, 4, 5, 6)]
                 + [("cell 2", 2, lvl, 768 >> lvl, 1344 >> lvl)
                    for lvl in (2, 3, 4, 5, 6)]
                 + [("cell 8", 2, lvl, 1152 >> lvl, 1984 >> lvl)
                    for lvl in (2, 3, 4, 5, 6)])


def _dense_inputs(n, h, w, od, seed):
    """A level's input in [-1, 1), its five convs' weights at the init's
    scale (normal, std sqrt(2 / (9 Cin))) and biases of +-0.01."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, od, h, w, generator=g) * 2 - 1
    ws, bs, cin = [], [], od
    for cout in (128, 128, 96, 64, 32):
        ws.append(torch.randn(cout, cin, 3, 3, generator=g)
                  * (2.0 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=g) * 0.01)
        cin += cout
    return x, ws, bs


def _dense_level(x, ws, bs):
    """The level's buffer as ``PWCDCNet._dense`` fills it without autograd."""
    from vfidkr_torch.ops import dense_conv as DC
    n, od, h, w = x.shape
    buf = x.new_empty((n, 448 + od, h, w))
    buf[:, 448:].copy_(x)
    start = 448
    for wt, b in zip(ws, bs):
        DC.dense_conv_into(buf, start, wt, b)
        start -= wt.shape[0]
    return buf


def _dense_errors(buf, ws, bs):
    """Each conv's largest error over the sum of |terms|, against float64 on
    the input the conv read."""
    import torch.nn.functional as F
    errs, start = [], 448
    for wt, b in zip(ws, bs):
        cout, cin = wt.shape[:2]
        xd, wd, bd = buf[:, start:start + cin].double(), wt.double(), b.double()
        want = F.leaky_relu(F.conv2d(xd, wd, bd, padding=1), 0.1)
        scale = F.conv2d(xd.abs(), wd.abs(), bd.abs(), padding=1)
        got = buf[:, start - cout:start].double()
        errs.append(((got - want).abs() / scale).max().item())
        start -= cout
    return errs


@pytest.mark.parametrize("cell,n,lvl,h,w", _DENSE_LEVELS)
def test_dense_conv_kernel(dev, cell, n, lvl, h, w):
    """K10 at each level of cells 1, 4, 2 and 8 (SoftSplat's 1080p): the
    five convs through the level's buffer, each held to float64 on the input
    it read, one launch a conv and no other kernel; the level run twice
    gives the same bits (split tiles at cells 1 and 4's levels 3 to 6,
    unsplit at cell 2's level 2)."""
    from vfidkr_torch import kernels
    x, ws, bs = _dense_inputs(n, h, w, _DENSE_OD[lvl], seed=30 + lvl)
    x, ws, bs = x.to(dev), [t.to(dev) for t in ws], [t.to(dev) for t in bs]
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        buf = _dense_level(x, ws, bs)
        again = _dense_level(x, ws, bs)
    torch.cuda.synchronize()
    assert _launched(before) == {"dense_conv": 10}
    assert torch.equal(buf, again)
    assert torch.equal(buf[:, 448:], x)
    errs = _dense_errors(buf, ws, bs)
    assert max(errs) <= DENSE_TOL, (cell, lvl, errs)
    assert bool((buf[:, :448] < 0).any()) and bool((buf[:, :448] > 0).any())


def test_dense_conv_splits_and_fresh_outputs(dev):
    """The split follows the shape: cells 1 and 4's level 3 takes a cluster,
    cell 2's level 2 none, and each is bit-stable over three runs; the
    fresh-output call gives the buffer call's bits, a ragged frame (W % 4 !=
    0, batch 3) included."""
    import torch.nn.functional as F
    from vfidkr_torch.ops import dense_conv as DC
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert DC.plan(2, 40, 64, 149, 128, sms)[1] > 1
    assert DC.plan(2, 192, 336, 117, 128, sms)[1] == 1
    for n, h, w, lvl in ((2, 40, 64, 3), (2, 192, 336, 2), (3, 37, 75, 4)):
        x, ws, bs = _dense_inputs(n, h, w, _DENSE_OD[lvl], seed=40 + lvl)
        x, ws, bs = x.to(dev), [t.to(dev) for t in ws], [t.to(dev) for t in bs]
        with torch.inference_mode():
            runs = [_dense_level(x, ws, bs) for _ in range(3)]
            buf = runs[0]
            fresh = DC.dense_conv(buf[:, 448:].contiguous(), ws[0], bs[0])
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])
        assert torch.equal(fresh, buf[:, 320:448])
        assert max(_dense_errors(buf, ws, bs)) <= DENSE_TOL
        plain = F.leaky_relu(F.conv2d(buf[:, 448:], ws[0], bs[0], padding=1),
                             0.1)
        assert (plain - fresh).abs().max().item() <= ATOL


def test_dain_launches_dense_conv_25_times(dev):
    """A DAIN forward launches K10 once a dense conv, 25 times, without
    autograd and under it, and its output is the CPU run's."""
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN
    g = torch.Generator().manual_seed(2)
    model = DAIN(generator=g).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.37, -0.21]))
    i0 = torch.rand(1, 3, 64, 128, generator=g)
    i2 = torch.rand(1, 3, 64, 128, generator=g)
    cpu = copy.deepcopy(model)
    gpu = model.to(dev)
    kernels.reset_launches()
    with torch.inference_mode():
        got = gpu.flownets(i0.to(dev), i2.to(dev))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dense_conv"] == 25
        gpu(i0.to(dev), i2.to(dev))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dense_conv"] == 50
        want = cpu.flownets(i0, i2)
    traced = gpu.flownets(i0.to(dev), i2.to(dev))
    traced.sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dense_conv"] == 75
    assert gpu.flownets.conv2_4[0].weight.grad is not None
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)


def test_dense_conv_gradients_match_cudnn(dev):
    """Under autograd K10's Function gives the input, weight and bias
    gradients of cuDNN's autograd of ``leaky_relu(conv2d)`` within 1e-5 of
    each gradient's largest magnitude: its backward is the same two nodes,
    ``leaky_relu_backward`` and ``convolution_backward`` on the saved
    tensors.  A frozen input gets no gradient."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import dense_conv as DC
    x, ws, bs = _dense_inputs(2, 40, 64, _DENSE_OD[3], seed=17)
    cot = torch.randn(2, 128, 40, 64,
                      generator=torch.Generator().manual_seed(18)).to(dev)
    leaves = [t.to(dev).requires_grad_() for t in (x, ws[0], bs[0])]
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    before = dict(kernels.LAUNCHES)
    out = DC.dense_conv(*leaves)
    assert _launched(before) == {"dense_conv": 1}
    assert type(out.grad_fn).__name__ == "_LeakyReluOfOutputBackward"
    assert type(out.grad_fn.next_functions[0][0]).__name__ == \
        "_DenseConvBackward"
    want = F.leaky_relu(F.conv2d(ref[0], ref[1], ref[2], padding=1), 0.1)
    assert torch.equal(out > 0, want > 0)
    got_g = torch.autograd.grad((out * cot).sum(), leaves)
    want_g = torch.autograd.grad((want * cot).sum(), ref)
    for name, a, e in zip("xwb", got_g, want_g):
        err = (a - e).abs().max().item()
        assert err <= 1e-5 * e.abs().max().item(), (name, err)
    frozen = DC.dense_conv(leaves[0].detach(), *leaves[1:])
    gw, gb = torch.autograd.grad((frozen * cot).sum(), leaves[1:])
    assert torch.allclose(gw, got_g[1], rtol=0,
                          atol=1e-5 * gw.abs().max().item())


def test_dense_conv_train_step_matches_cudnn_path(dev, monkeypatch):
    """A DAIN train step with K10 in PWC-Net against the same step with the
    dense convs on cuDNN (the plain version on the card), within the
    training cell's check limits: the loss within 3e-6 relative, each
    leaf's gradient norm within 1.5e-4 of the larger of its reference norm
    and the median leaf's."""
    import copy
    import statistics
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN, pwcnet
    from vfidkr_torch.ops import dense_conv as DC
    from vfidkr_torch.training import TrainConfig, make_optimizer, train_step
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(23)
    model = DAIN(generator=g, init_unused=False)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.37, -0.21]))
    batch = {k: F.interpolate(torch.rand(2, 3, 16, 32, generator=g),
                              size=(64, 128), mode="bilinear",
                              align_corners=False).to(dev)
             for k in ("x0", "x1", "y")}
    k10 = model.to(dev)
    cudnn = copy.deepcopy(k10)
    config = TrainConfig()
    before = kernels.LAUNCHES["dense_conv"]
    got = train_step(k10, make_optimizer(k10, config), batch, config)
    assert kernels.LAUNCHES["dense_conv"] == before + 25
    monkeypatch.setattr(pwcnet, "dense_conv", DC.dense_conv_plain)
    want = train_step(cudnn, make_optimizer(cudnn, config), batch, config)
    assert kernels.LAUNCHES["dense_conv"] == before + 25
    torch.cuda.synchronize()
    loss, ref = got["total"].item(), want["total"].item()
    assert abs(loss - ref) <= 3e-6 * abs(ref), (loss, ref)
    norms = {n: (a.grad.norm().item(), b.grad.norm().item())
             for (n, a), b in zip(k10.named_parameters(), cudnn.parameters())
             if b.grad is not None}
    median = statistics.median(r for _, r in norms.values())
    gaps = {n: abs(a - r) / max(r, median) for n, (a, r) in norms.items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1.5e-4, (worst, gaps[worst])


def test_dense_conv_rejects_bad_inputs(dev):
    from vfidkr_torch.ops import dense_conv as DC
    x, ws, bs = _dense_inputs(1, 8, 16, 13, seed=1)
    x, wt, b = x.to(dev), ws[0].to(dev), bs[0].to(dev)
    with pytest.raises(TypeError, match="float32"):
        DC.dense_conv(x.half(), wt, b)
    with pytest.raises(ValueError, match="contiguous"):
        DC.dense_conv(x.transpose(2, 3), wt, b)
    with pytest.raises(ValueError, match="multiple of 32"):
        DC.dense_conv(x, wt[:48].contiguous(), b[:48].contiguous())
    with pytest.raises(ValueError, match="different devices"):
        DC.dense_conv(x, wt.cpu(), b)
    buf = torch.zeros(1, 128 + 13, 8, 16, device=dev)
    with pytest.raises(ValueError, match="autograd"):
        DC.dense_conv_into(buf, 128, wt.requires_grad_(), b)


# K11, PWC-Net's flow heads: each value against the plain conv on the card
# (cuDNN in float32, TF32 off) within ATOL x max(1, |plain|).  Float32 sums
# of 5,000-6,000 terms in another order differ by about 1e-6 at these
# scales; TF32 products would differ by 1e-3.
_HEAD_C = {6: 529, 5: 661, 4: 629, 3: 597, 2: 565}
# each level's map: cells 1 and 4, cell 2 and cell 8 (SoftSplat at 1984 x
# 1152; batch 2), a B = 3 train step
# at 256 x 448 (batch 6), cell 5's level 2 (batch 80), ragged frames, and C
# that no split divides (37: 5 stages; 131: 17)
_HEAD_CASES = ([("cells 1, 4", 2, _HEAD_C[lvl], 320 >> lvl, 512 >> lvl)
                for lvl in (2, 3, 4, 5, 6)]
               + [("cell 2", 2, _HEAD_C[lvl], 768 >> lvl, 1344 >> lvl)
                  for lvl in (2, 3, 4, 5, 6)]
               + [("cell 8", 2, _HEAD_C[lvl], 1152 >> lvl, 1984 >> lvl)
                  for lvl in (2, 3, 4, 5, 6)]
               + [("batch 6", 6, _HEAD_C[lvl], 256 >> lvl, 448 >> lvl)
                  for lvl in (2, 3, 4, 5, 6)]
               + [("cell 5", 80, _HEAD_C[2], 64, 112),
                  ("cell 5", 80, _HEAD_C[6], 4, 7),
                  ("ragged", 2, 565, 37, 75), ("ragged", 2, 529, 5, 8),
                  ("odd C", 2, 37, 20, 32), ("odd C", 3, 131, 9, 13)])


def _head_inputs_k11(n, c, h, w, seed):
    """A level's buffer in [-1, 1), the head's weights at the init's scale
    (normal, std sqrt(2 / (9 C))) and the biases the benchmark draws."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, c, h, w, generator=g) * 2 - 1
    wt = torch.randn(2, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5
    b = torch.randn(2, generator=g) * 0.01 + torch.tensor([0.53, -0.31])
    return x, wt, b


def _head_close(label, got, plain):
    err = ((got - plain).abs() / plain.abs().clamp(min=1.0)).max().item()
    assert err <= ATOL, (label, err)


@pytest.mark.parametrize("label,n,c,h,w", _HEAD_CASES)
def test_flow_head_kernel(dev, label, n, c, h, w):
    """K11 at the plan's tile and split, one launch a call and no other
    kernel, against the plain conv; two launches give the same bits."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_head as FH
    x, wt, b = (t.to(dev) for t in _head_inputs_k11(n, c, h, w, seed=h + c))
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = FH.flow_head(x, wt, b)
        again = FH.flow_head(x, wt, b)
    torch.cuda.synchronize()
    assert _launched(before) == {"flow_head": 2}
    assert got.shape == (n, 2, h, w) and got.is_contiguous()
    assert torch.equal(got, again)
    _head_close(label, got, F.conv2d(x, wt, b, padding=1))


@pytest.mark.parametrize("n,c,h,w", [(2, 597, 40, 64), (2, 131, 9, 13),
                                     (2, 565, 37, 75)])
def test_flow_head_every_tile_and_split(dev, n, c, h, w):
    """Every tile and every split the kernel takes (1 to 16 blocks, at
    most the stages of 8 channels, powers of two or not) gives the plain
    conv's values; a split past the stages or 16 is refused."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    x, wt, b = (t.to(dev) for t in _head_inputs_k11(n, c, h, w, seed=c))
    plain = F.conv2d(x, wt, b, padding=1)
    stages = -(-c // 8)
    for rows in (8, 16):
        for split in range(1, min(16, stages) + 1):
            out = torch.empty(n, 2, h, w, device=dev)
            kernels.launch("flow_head", x, wt, b, out, n, c, h, w, rows,
                           split)
            _head_close((rows, split), out, plain)
    out = torch.empty(n, 2, h, w, device=dev)
    for rows, split in ((16, min(17, stages + 1)), (4, 1), (8, 0)):
        with pytest.raises(RuntimeError, match="flow_head"):
            kernels.launch("flow_head", x, wt, b, out, n, c, h, w, rows,
                           split)


def test_flow_head_gradients_match_cudnn(dev):
    """Under autograd K11's Function gives the input, weight and bias
    gradients of cuDNN's autograd of ``conv2d`` within 1e-5 of each
    gradient's largest magnitude: its backward is the same
    ``convolution_backward`` on the saved tensors.  A frozen input gets no
    gradient."""
    import torch.nn.functional as F
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_head as FH
    x, wt, b = _head_inputs_k11(2, 597, 40, 64, seed=19)
    cot = torch.randn(2, 2, 40, 64,
                      generator=torch.Generator().manual_seed(20)).to(dev)
    leaves = [t.to(dev).requires_grad_() for t in (x, wt, b)]
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    before = dict(kernels.LAUNCHES)
    out = FH.flow_head(*leaves)
    assert _launched(before) == {"flow_head": 1}
    assert type(out.grad_fn).__name__ == "_FlowHeadBackward"
    want = F.conv2d(ref[0], ref[1], ref[2], padding=1)
    _head_close("forward", out.detach(), want.detach())
    got_g = torch.autograd.grad((out * cot).sum(), leaves)
    want_g = torch.autograd.grad((want * cot).sum(), ref)
    for name, a, e in zip("xwb", got_g, want_g):
        err = (a - e).abs().max().item()
        assert err <= 1e-5 * e.abs().max().item(), (name, err)
    frozen = FH.flow_head(leaves[0].detach(), *leaves[1:])
    gw, gb = torch.autograd.grad((frozen * cot).sum(), leaves[1:])
    assert torch.allclose(gw, got_g[1], rtol=0,
                          atol=1e-5 * gw.abs().max().item())


def test_flow_head_rejects_bad_inputs(dev):
    from vfidkr_torch.ops import flow_head as FH
    x, wt, b = (t.to(dev) for t in _head_inputs_k11(1, 13, 8, 16, seed=1))
    with pytest.raises(TypeError, match="float32"):
        FH.flow_head(x.half(), wt, b)
    with pytest.raises(ValueError, match="contiguous"):
        FH.flow_head(x.transpose(2, 3), wt, b)
    with pytest.raises(ValueError, match="3x3"):
        FH.flow_head(x, torch.zeros(3, 13, 3, 3, device=dev), b)
    with pytest.raises(ValueError, match="different devices"):
        FH.flow_head(x, wt.cpu(), b)


def test_pwcnet_launches_flow_head_5_times(dev, monkeypatch):
    """A PWC-Net forward launches K11 once a level, 5 times, without
    autograd and under it, and no head reaches cuDNN's forward conv (the
    module's own call raises here); its flow is the plain heads' within
    1e-4 (every level's flow feeds the next level's warp)."""
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import pwcnet
    from vfidkr_torch.models.pwcnet import PWCDCNet
    from vfidkr_torch.ops import flow_head as FH
    net = PWCDCNet(generator=torch.Generator().manual_seed(2)).to(dev)
    g = torch.Generator().manual_seed(3)
    im1, im2 = (torch.rand(1, 3, 128, 192, generator=g).to(dev)
                for _ in range(2))
    plain = copy.deepcopy(net)

    def refuse(*args):
        raise AssertionError("a flow head ran its module's conv")

    for lvl in (6, 5, 4, 3, 2):
        monkeypatch.setattr(getattr(net, f"predict_flow{lvl}"), "forward",
                            refuse)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = net.bidirectional(im1, im2)
    torch.cuda.synchronize()
    assert _launched(before) == {"dense_conv": 25, "flow_head": 5,
                                 "correlation": 5}
    traced = net(im1, im2)
    traced.sum().backward()
    torch.cuda.synchronize()
    assert _launched(before) == {"dense_conv": 50, "flow_head": 10,
                                 "correlation": 10, "correlation_bwd": 5}
    assert net.predict_flow3.weight.grad is not None
    monkeypatch.setattr(pwcnet, "flow_head", FH.flow_head_plain)
    with torch.inference_mode():
        want = plain.bidirectional(im1, im2)
    assert _launched(before) == {"dense_conv": 75, "flow_head": 10,
                                 "correlation": 15, "correlation_bwd": 5}
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


# K13, PWC-Net's cost volume and its LeakyReLU, forward and backward: each
# value against the float64 plain versions, its error over the float64 sum
# of its terms' magnitudes within torch_corr.TOL, at every level of cells
# 1/4, 5 and 8 and at ragged shapes (torch_corr.CASES).
def _corr_close(label, errs):
    for key, (err, _) in errs.items():
        assert err <= torch_corr.TOL, (label, key, err)


@pytest.mark.parametrize("label,n,c,h,w", torch_corr.CASES)
def test_correlation_kernel(dev, label, n, c, h, w):
    """K13 through the wrapper under autograd: the output against float64,
    both gradients against the float64 plain backward on the same saved
    output (the slope is read from its sign: a value within rounding of 0
    may take the other sign in float64), one launch of each entry point a
    call and no other kernel of the port."""
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import correlation as CV
    f1, f2, g = torch_corr.inputs(n, c, h, w, seed=h * w + c, device=dev)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    before = dict(kernels.LAUNCHES)
    out = CV.cost_volume(a1, a2)
    gf1, gf2 = torch.autograd.grad(out, (a1, a2), g)
    torch.cuda.synchronize()
    assert _launched(before) == {"correlation": 1, "correlation_bwd": 1}
    assert out.shape == (n, 81, h, w) and out.is_contiguous()
    _corr_close(label, torch_corr.errors(f1, f2, g, out, gf1, gf2))


@pytest.mark.parametrize("label,n,c,h,w", [torch_corr.CASES[0],
                                           torch_corr.CASES[5],
                                           torch_corr.CASES[-5]])
def test_correlation_backward_is_bit_stable(dev, label, n, c, h, w):
    """Two backward runs give the same bits (no atomics: each gradient
    summed in one fixed order), both gradients and each alone; a frozen
    input gets no gradient and its pass is not run."""
    from vfidkr_torch.ops import correlation as CV
    f1, f2, g = torch_corr.inputs(n, c, h, w, seed=7, device=dev)
    with torch.no_grad():
        out = CV.cost_volume(f1, f2)
    first = CV._launch_bwd(f1, f2, out, g, True, True)
    second = CV._launch_bwd(f1, f2, out, g, True, True)
    only1 = CV._launch_bwd(f1, f2, out, g, True, False)
    only2 = CV._launch_bwd(f1, f2, out, g, False, True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                             second[1])
    assert only1[1] is None and only2[0] is None
    assert torch.equal(only1[0], first[0]) and torch.equal(only2[1], first[1])
    a2 = f2.clone().requires_grad_()
    (gf2,) = torch.autograd.grad(CV.cost_volume(f1, a2), (a2,), g)
    assert torch.equal(gf2, first[1])


def test_correlation_rejects_bad_inputs(dev):
    """On the card the wrapper raises where the kernel does not take its
    input; it never falls back to the plain version."""
    from vfidkr_torch.ops import correlation as CV
    f1, f2, _ = torch_corr.inputs(2, 8, 9, 16, seed=1, device=dev)
    with pytest.raises(TypeError, match="float32"):
        CV.cost_volume(f1.bfloat16(), f2.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        CV.cost_volume(f1.transpose(2, 3), f2.transpose(2, 3))
    with pytest.raises(ValueError, match="differ"):
        CV.cost_volume(f1, f2[:, :4].contiguous())
    with pytest.raises(ValueError, match="displacement"):
        CV.cost_volume(f1, f2, 3)
    with pytest.raises(ValueError, match="different devices"):
        CV.cost_volume(f1, f2.cpu())


def test_pwcnet_launches_correlation_5_times(dev, monkeypatch):
    """A PWC-Net forward launches K13 once a level, 5 times, with nothing
    else new launched, without autograd and under it (and its backward 5
    times); its flow is the plain cost volume's within 1e-4 (every level's
    flow feeds the next level's warp)."""
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import pwcnet
    from vfidkr_torch.models.pwcnet import PWCDCNet
    from vfidkr_torch.ops import correlation as CV
    net = PWCDCNet(generator=torch.Generator().manual_seed(4)).to(dev)
    g = torch.Generator().manual_seed(5)
    im1, im2 = (torch.rand(1, 3, 128, 192, generator=g).to(dev)
                for _ in range(2))
    plain = copy.deepcopy(net)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = net.bidirectional(im1, im2)
    torch.cuda.synchronize()
    assert _launched(before) == {"dense_conv": 25, "flow_head": 5,
                                 "correlation": 5}
    net(im1, im2).sum().backward()
    torch.cuda.synchronize()
    assert _launched(before) == {"dense_conv": 50, "flow_head": 10,
                                 "correlation": 10, "correlation_bwd": 5}
    assert net.conv6b[0].weight.grad is not None
    monkeypatch.setattr(pwcnet, "cost_volume",
                        lambda a, b, md: CV.cost_volume_plain(a, b))
    with torch.inference_mode():
        want = plain.bidirectional(im1, im2)
    assert _launched(before) == {"dense_conv": 75, "flow_head": 15,
                                 "correlation": 10, "correlation_bwd": 5}
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


# K14, AdaCoF's sampling of both frames and their occlusion blend, at
# tests/torch_adacof.py's shapes against its float64 yardstick.
@pytest.mark.parametrize("label,n,h,w,f,d,kind", torch_adacof.CASES)
def test_adacof_kernel(dev, label, n, h, w, f, d, kind):
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import adacof as AC
    args = torch_adacof.inputs(dev, n, h, w, f, kind, seed=h * w + f)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = AC.adacof_pair(*args, d)
        again = AC.adacof_pair(*args, d)
    torch.cuda.synchronize()
    assert _launched(before) == {"adacof": 2}
    assert torch.equal(got, again), label       # one fixed order, no atomics
    ok, rel, _ = torch_adacof.errors(args, d, got)
    assert ok, (label, rel)


def test_adacof_forward_launches_k14_once_and_matches_cpu(dev):
    """An AdaCoF+ forward at 128 x 192 launches K14 once and nothing else of
    the library, and its frame is the CPU's within 1e-4 (cuDNN's float32
    convs against the CPU's through the U-Net and the heads)."""
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import AdaCoFPlus
    cpu = AdaCoFPlus(torch.Generator().manual_seed(6)).eval()
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.startswith(("moduleAlpha", "moduleBeta")) and \
                    name.endswith("7.bias"):
                p.add_(3.0)                  # samples a few px away
    gpu = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(7)
    i0, i2 = torch.rand(2, 1, 3, 128, 192, generator=g)
    before = dict(kernels.LAUNCHES)
    with torch.inference_mode():
        got = gpu(i0.to(dev), i2.to(dev))["outputs"][0]
        want = cpu(i0, i2)["outputs"][0]
    torch.cuda.synchronize()
    assert _launched(before) == {"adacof": 1}
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_adacof_kernel_refuses_what_it_does_not_take(dev):
    from vfidkr_torch.ops import adacof as AC
    args = list(torch_adacof.inputs(dev, 1, 8, 8, 3, "tamed", seed=1))
    grad = [a.clone().requires_grad_(True) if k == 1 else a
            for k, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no backward"):
        AC.adacof_pair(*grad, 1)
    four = list(args)
    four[0] = four[4] = torch.rand(1, 4, 8, 8, device=dev)
    with pytest.raises(ValueError, match="3 channels"):
        AC.adacof_pair(*four, 1)
    moved = list(args)
    moved[8] = moved[8].cpu()
    with pytest.raises(ValueError, match="different devices"):
        AC.adacof_pair(*moved, 1)
    with pytest.raises(ValueError, match="contiguous"):
        strided = list(args)
        strided[1] = strided[1].transpose(2, 3).contiguous().transpose(2, 3)
        AC.adacof_pair(*strided, 1)
