"""The gradient of the port's depth-weighted flow projection against the
JAX package's, on the same inputs made with numpy from a seed.

JAX's ``depth_flow_project`` has a ``custom_vjp`` that follows the reference
CUDA backward (``vfidkr_tpu/ops/flow_projection.py:545-581``); its depth
gradient has ``(f - out)`` where the autodiff of the forward gives
``(f + out)``.  The port's ``depth_flow_project`` is one autograd Function
whose backward is the kernel ``depth_flow_project_bwd`` on the card and
``depth_flow_project_bwd_plain`` here.

Tolerance: rtol 1e-5, atol 1e-6 x the largest magnitude of JAX's gradient
(float32 quotients and four-term sums, in the same order on both sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfidkr_tpu.ops import depth_flow_project as jax_depth_flow_project  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402

import torch_geometry as geo  # noqa: E402

B, H, W = 2, 16, 32


def nchw(a):
    """NHWC numpy array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _flow(rng, case):
    """NHWC flows: a smooth move, landings on and beyond the last row and
    column (a cell read twice), and a random field with invalid landings."""
    if case == "smooth":
        return geo.smooth_flow(rng, B, H, W, 3.0, (1.3, -0.7)).transpose(
            0, 2, 3, 1).copy()
    if case == "border":
        flow = np.zeros((1, H, W, 2), np.float32)
        flow[0, :, :, 1] = 2.25
        flow[0, H - 1, :, 1] = 0.0
        flow[0, :, W - 1, 0] = 0.0
        flow[0, 3, W - 2] = (1.0, 0.0)
        return flow
    flow = ((rng.rand(B, H, W, 2) - 0.5) * 12).astype(np.float32)
    flow[0, 2:5, 1:4] = (-20.0, 0.0)           # off the frame
    flow[1, H - 3:, 6:9] = (0.0, 7.0)
    return flow


def _depth(rng, flow):
    b, h, w, _ = flow.shape
    return (1e-6 + np.exp(-rng.uniform(-1, 3, (b, h, w)))).astype(np.float32)


def _port_vjp(flow, depth, g, hole_fill, need_depth=True):
    f = nchw(flow).requires_grad_()
    d = torch.from_numpy(depth).requires_grad_(need_depth)
    out = FP.depth_flow_project(f, d, hole_fill=hole_fill)
    leaves = [f, d] if need_depth else [f]
    grads = torch.autograd.grad(out, leaves, nchw(g))
    return out, [nhwc(grads[0])] + [x.numpy() for x in grads[1:]]


@pytest.mark.parametrize("hole_fill", [False, True])
@pytest.mark.parametrize("case", ["smooth", "border", "random"])
def test_depth_flow_project_vjp_matches_jax(rng, case, hole_fill):
    """Flow and depth gradients under a random cotangent of the projected
    flow; with ``hole_fill`` the forward fills and the gradient is the
    unfilled average's, on both sides."""
    flow = _flow(rng, case)
    depth = _depth(rng, flow)
    g = rng.randn(*flow.shape).astype(np.float32)
    kernels.reset_launches()
    out, got = _port_vjp(flow, depth, g, hole_fill)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    want_out, vjp = jax.vjp(
        lambda f, d: jax_depth_flow_project(f, d, hole_fill=hole_fill),
        jnp.asarray(flow), jnp.asarray(depth))
    np.testing.assert_allclose(nhwc(out), np.asarray(want_out), rtol=1e-5,
                               atol=1e-5)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    for a, b, name in zip(got, want, ("flow", "depth")):
        assert a.shape == b.shape and np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    # the flow gradient alone: the kernel then skips the depth gradient
    _, (gflow,) = _port_vjp(flow, depth, g, hole_fill, need_depth=False)
    np.testing.assert_array_equal(gflow, got[0])


def test_depth_gradient_keeps_f_minus_out(rng):
    """The port's depth gradient is JAX's (the reference's ``(f - out)``),
    not the autodiff of the plain forward (``(f + out)``); their flow
    gradients agree."""
    flow = _flow(rng, "random")
    depth = _depth(rng, flow)
    g = rng.randn(*flow.shape).astype(np.float32)
    _, (gflow, gdepth) = _port_vjp(flow, depth, g, hole_fill=False)
    _, vjp = jax.vjp(lambda f, d: jax_depth_flow_project(f, d),
                     jnp.asarray(flow), jnp.asarray(depth))
    want = np.asarray(vjp(jnp.asarray(g))[1])
    np.testing.assert_allclose(gdepth, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())

    f = nchw(flow).requires_grad_()
    d = torch.from_numpy(depth).requires_grad_()
    auto = FP._count_average(FP.scatter4_plain(f, d))
    af, ad = torch.autograd.grad(auto, [f, d], nchw(g))
    np.testing.assert_allclose(nhwc(af), gflow, rtol=1e-5,
                               atol=1e-6 * np.abs(gflow).max())
    gap = np.abs(ad.numpy() - want)
    assert gap.max() > 0.1 * np.abs(want).max()


@pytest.fixture
def fake_kernels(monkeypatch):
    """Route kernel launches to a recorder: meta tensors then take the CUDA
    wrappers' path on this machine, with no data."""
    calls = []
    monkeypatch.setattr(kernels, "check_inputs", lambda name, *ts: None)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("hole_fill", [False, True])
def test_depth_projection_launches_its_backward(fake_kernels, hole_fill):
    """On a card the forward launches the weighted scatter (and the fill);
    the backward launches ``depth_flow_project_bwd`` with a depth gradient
    only where the depth needs one, else NULL."""
    flow = torch.zeros(2, 2, 8, 8, device="meta", requires_grad=True)
    depth = torch.ones(2, 8, 8, device="meta")
    out = FP.depth_flow_project(flow, depth, hole_fill=hole_fill)
    forward = ["flow_project_scatter"] + (
        ["flow_project_finalize"] if hole_fill else [])
    assert [c[0] for c in fake_kernels] == forward
    assert fake_kernels[0][1][1] is not None        # the weight
    out.backward(torch.ones_like(out))
    name, args = fake_kernels[-1]
    assert name == "depth_flow_project_bwd"
    assert args[6] is None and flow.grad.shape == flow.shape
    assert args[3].shape == (2, 8, 8) and args[3].is_contiguous()   # cnt

    fake_kernels.clear()
    depth.requires_grad_()
    out = FP.depth_flow_project(flow, depth[:, None], hole_fill=hole_fill)
    out.sum().backward()
    assert fake_kernels[-1][1][6] is not None
    assert depth.grad.shape == depth.shape

    fake_kernels.clear()
    with torch.no_grad():
        FP.depth_flow_project(flow, depth, hole_fill=hole_fill)
    assert [c[0] for c in fake_kernels] == forward
