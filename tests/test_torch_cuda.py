"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip without
one.  They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-5 absolute (float32 sums in another order; the scatter's
atomic adds in any order); hit counts exactly.  Gradients: 1e-5 x the
tensor's largest magnitude (at least 1), since the image gradient's atomic
adds pile up at the frame's edge.  The kernels take float32 only, so
``torch.autograd.gradcheck`` (float64) does not apply: the backward kernels
are held to the autograd of the plain forwards.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flow(g, n, h, w, scale):
    flow = (torch.rand(n, 2, h, w, generator=g) * 2 - 1) * scale
    flow[0, :, 1, w - 4] = torch.tensor([3.0, 0.0])          # x2 == W-1
    flow[0, :, 2, 0] = torch.tensor([w / 2, 0.0])            # |fx| == W/2
    flow[-1, :, h - 1, 3] = torch.tensor([0.0, -(h - 1.0)])  # y2 == 0
    return flow


@pytest.mark.parametrize("c", [3, 16])
def test_filter_interpolate_kernel(dev, c):
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import filter_interpolation as FI
    g = torch.Generator().manual_seed(0)
    n, h, w = 2, 40, 72
    image = torch.rand(n, c, h, w, generator=g).to(dev)
    flow = _flow(g, n, h, w, 20.0).to(dev)
    filt = torch.randn(n, 16, h, w, generator=g).to(dev)
    before = kernels.LAUNCHES["filter_interpolate_fwd"]
    got = FI.filter_interpolate(image, flow, filt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["filter_interpolate_fwd"] == before + 1
    want = FI.filter_interpolate_plain(image, flow, filt)
    assert (got - want).abs().max().item() <= ATOL


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
                                    "flow_project_scatter_bwd": 0}
        want = cpu(i0, i2)
    for key, atol in (("offsets", 1e-4), ("outputs", 2e-4)):
        for a, b in zip(got[key], want[key]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=atol)


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
    for name in ("filter_interpolate_fwd", "filter_interpolate_bwd"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    want = grads(FI.filter_interpolate_plain)
    if not need_image:
        assert got[0] is None and want[0] is None
    for name, a, b in zip(("image", "flow", "filt"), got, want):
        if b is not None:
            _grads_close(name, a, b)


@pytest.mark.parametrize("case", ["random", "border"])
def test_flow_project_scatter_bwd_kernel(dev, case):
    from vfidkr_torch import kernels
    from vfidkr_torch.ops import flow_projection as FP
    g = torch.Generator().manual_seed(4)
    n, h, w = 2, 40, 72
    if case == "random":
        flow = _flow(g, n, h, w, 12.0)
    else:
        # landings on and beyond the last row and column: two of the four
        # targets are one cell, added to (and read back) twice
        flow = torch.zeros(n, 2, h, w)
        flow[:, 1] = 2.25
        flow[:, 1, h - 1] = 0.0
        flow[:, 0, :, w - 1] = 0.0
        flow[1, 0, 3, w - 2] = 1.0
    flow = flow.to(dev)
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
    proj = lambda f: FP.flow_project(f, hole_fill=False)
    want = grads(lambda f: FP._count_average(FP.scatter4_plain(f)), out_cot)
    _grads_close("flow_project", grads(proj, out_cot), want)


def test_dain_train_step_cuda_matches_cpu(dev):
    import copy
    from vfidkr_torch import kernels
    from vfidkr_torch.models import DAIN
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
                                "flow_project_scatter_bwd": 1}
    want = train_step(cpu, make_optimizer(cpu, config), batch, config)
    torch.testing.assert_close(got["total"].cpu(), want["total"], rtol=1e-4,
                               atol=0)
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        scale = max(a.grad.abs().max().item(), b.grad.abs().max().item(),
                    1e-12)
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=5e-3,
                                   atol=5e-3 * scale, msg=name)
