"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip without
one.  They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-5 absolute (float32 sums in another order; the scatter's
atomic adds in any order); hit counts exactly.
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
        assert all(n == 1 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
        want = cpu(i0, i2)
    for key, atol in (("offsets", 1e-4), ("outputs", 2e-4)):
        for a, b in zip(got[key], want[key]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=atol)
