"""The reference's dormant ops in the port (vfidkr_torch.ops: the deformable
filter interpolations, interpolate_bilinear, min_depth_flow_project and the
separable convs; plain PyTorch on every device) and the small pieces beside
them (the align-corners upsample, the replication pad, smooth_loss and the
running mean) against the JAX package on the same numpy inputs, made from a
seed.

Tolerances: float32 forwards within 1e-5 x max(1, |JAX|) (sums in another
order); each input's gradient under a random cotangent within 1e-5 x max(1,
max |JAX gradient|); min_depth_flow_project's forward, and its gradient
without the fill, and separable_conv_flow's -2000 sentinel exactly.  The
flows are continuous random draws, so no landing sits on a clamp's bound,
where JAX's ``jnp.clip`` halves the gradient and the port's clamp does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vfidkr_tpu.ops as jops  # noqa: E402
from vfidkr_tpu.models.layers import replication_pad as jax_replication_pad  # noqa: E402
from vfidkr_tpu.models.layers import \
    upsample_bilinear_align_corners as jax_upsample_ac  # noqa: E402
from vfidkr_tpu.training.loss import smooth_loss as jax_smooth_loss  # noqa: E402
from vfidkr_tpu.utils.meters import RunningMean as JaxRunningMean  # noqa: E402

import vfidkr_torch.ops as tops  # noqa: E402
from vfidkr_torch.models.layers import (replication_pad,  # noqa: E402
                                        upsample_bilinear_align_corners)
from vfidkr_torch.parallel.spatial import (ShardAxis, _Rendezvous,  # noqa: E402
                                           spatial_frame)
from vfidkr_torch.training import smooth_loss  # noqa: E402
from vfidkr_torch.utils import AverageMeter, RunningMean  # noqa: E402

TOL = 1e-5


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, what):
    want = np.asarray(want)
    scale = np.maximum(1.0, np.abs(want))
    err = (np.abs(got - want) / scale).max()
    assert err <= TOL, f"{what}: {err} exceeds {TOL}"


def _hold(jax_fn, torch_fn, inputs, grads_of, what):
    """Forward and VJP of ``jax_fn`` on NHWC ``inputs`` against the port's
    ``torch_fn`` on their NCHW copies, for the inputs named in
    ``grads_of``; the cotangent is a seeded draw."""
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
    cot = np.random.RandomState(7).randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = [nchw(a).requires_grad_(i in grads_of) for i, a in enumerate(inputs)]
    out = torch_fn(*ts)
    _close(nhwc(out), want, f"{what} forward")
    out.backward(nchw(cot))
    for i in grads_of:
        g = np.asarray(want_grads[i])
        got = nhwc(ts[i].grad)
        err = np.abs(got - g).max()
        tol = TOL * max(1.0, np.abs(g).max())
        assert err <= tol, f"{what} gradient of input {i}: {err} > {tol}"
    return out


def _frame_case(rng, h, w, c=3, n=2, reach=4.0):
    image = rng.rand(n, h, w, c).astype(np.float32)
    flow = ((rng.rand(n, h, w, 2) * 2 - 1) * reach).astype(np.float32)
    flow[0, 1, 2, 0] = w          # |fx| >= W/2: the pixel copies the image
    return image, flow


# ---------------------------------------------------------------------------
# the deformable filter interpolations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["static", "deformed", "nofilter"])
@pytest.mark.parametrize("h,w", [(9, 11), (13, 17)])
def test_deformable_matches_jax(variant, h, w):
    rng = np.random.RandomState(h * w)
    image, flow = _frame_case(rng, h, w)
    filt = rng.rand(2, h, w, 16).astype(np.float32)
    # offsets within +-1.5 px: deformed taps cross the frame's edge, and
    # trunc and floor part for the negative ones
    off = ((rng.rand(2, h, w, 32) * 2 - 1) * 1.5).astype(np.float32)
    if variant == "nofilter":
        out = _hold(jops.filter_interpolate_nofilter_deformable,
                    tops.filter_interpolate_nofilter_deformable,
                    [image, flow, off], (0, 1, 2), variant)
    else:
        out = _hold(lambda *a: jops.filter_interpolate_deformable(
                        *a, quadrant=variant),
                    lambda *a: tops.filter_interpolate_deformable(
                        *a, quadrant=variant),
                    [image, flow, filt, off], (0, 1, 2, 3), variant)
    assert out.shape == (2, 3, h, w)
    # the invalid pixel copies the image
    assert torch.equal(out[0, :, 1, 2], nchw(image)[0, :, 1, 2])


def test_deformable_refuses_bad_arguments():
    image = torch.rand(1, 3, 8, 8)
    flow = torch.zeros(1, 2, 8, 8)
    filt = torch.rand(1, 16, 8, 8)
    with pytest.raises(ValueError, match="quadrant"):
        tops.filter_interpolate_deformable(image, flow, filt,
                                           torch.zeros(1, 32, 8, 8), "both")
    with pytest.raises(ValueError, match="offsets"):
        tops.filter_interpolate_deformable(image, flow, filt,
                                           torch.zeros(1, 16, 8, 8))


def test_dormant_ops_raise_inside_a_spatial_frame():
    flow = torch.zeros(1, 2, 8, 8)
    with spatial_frame(ShardAxis(_Rendezvous(1), 0), 2):
        with pytest.raises(RuntimeError, match="spatial frame"):
            tops.min_depth_flow_project(flow, torch.ones(1, 8, 8))
        with pytest.raises(RuntimeError, match="spatial frame"):
            tops.filter_interpolate_nofilter_deformable(
                torch.rand(1, 3, 8, 8), flow, torch.zeros(1, 32, 8, 8))


# ---------------------------------------------------------------------------
# interpolate_bilinear, min_depth_flow_project, the separable convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(9, 11), (13, 17)])
def test_interpolate_bilinear_matches_jax(h, w):
    image, flow = _frame_case(np.random.RandomState(h), h, w, c=5)
    # landings past the last column: valid below W (the reference's
    # exclusive bound), 0 at W
    flow[1, h - 1, w - 1] = (0.5, 0.25)
    flow[1, h - 2, w - 2] = (2.0, 0.0)
    out = _hold(jops.interpolate_bilinear, tops.interpolate_bilinear,
                [image, flow], (0, 1), "interpolate_bilinear").detach()
    assert float(out[1, 0, h - 1, w - 1]) != 0.0
    assert float(out[1, :, h - 2, w - 2].abs().sum()) == 0.0


def _min_depth_case(h, w):
    rng = np.random.RandomState(h + w)
    flow = ((rng.rand(2, h, w, 2) * 2 - 1) * 3).astype(np.float32)
    flow[0, 0, :3, 0] = -5.0                 # landings left of the frame
    # two depth levels: many cells get ties, which the highest source wins
    depth = (1.0 + 0.5 * (rng.rand(2, h, w) < 0.5)).astype(np.float32)
    return flow, depth


@pytest.mark.parametrize("hole_fill", [False, True])
@pytest.mark.parametrize("h,w", [(9, 11), (13, 17)])
def test_min_depth_flow_project_matches_jax(h, w, hole_fill):
    flow, depth = _min_depth_case(h, w)
    want, vjp = jax.vjp(lambda f: jops.min_depth_flow_project(
        f, jnp.asarray(depth), hole_fill=hole_fill), jnp.asarray(flow))
    t = nchw(flow).requires_grad_()
    out = tops.min_depth_flow_project(t, torch.from_numpy(depth), hole_fill)
    np.testing.assert_array_equal(nhwc(out), np.asarray(want))
    if not hole_fill:
        holes = (np.asarray(want) == 0).all(-1).mean()
        assert 0.05 < holes < 0.7, holes      # the z-buffer leaves holes
    cot = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
    out.backward(nchw(cot))
    g = np.asarray(vjp(jnp.asarray(cot))[0])
    if hole_fill:
        np.testing.assert_allclose(nhwc(t.grad), g, rtol=0,
                                   atol=TOL * max(1.0, np.abs(g).max()))
    else:
        np.testing.assert_array_equal(nhwc(t.grad), g)


def test_min_depth_flow_project_takes_a_1_channel_depth():
    flow, depth = _min_depth_case(9, 11)
    a = tops.min_depth_flow_project(nchw(flow), torch.from_numpy(depth))
    b = tops.min_depth_flow_project(nchw(flow),
                                    torch.from_numpy(depth)[:, None])
    assert torch.equal(a, b)


@pytest.mark.parametrize("fs,h,w", [(4, 9, 11), (5, 13, 17)])
def test_separable_conv_matches_jax(fs, h, w):
    rng = np.random.RandomState(fs)
    image = rng.rand(2, h, w, 3).astype(np.float32)
    vert = rng.randn(2, h - fs + 1, w - fs + 1, fs).astype(np.float32)
    horiz = rng.randn(2, h - fs + 1, w - fs + 1, fs).astype(np.float32)
    out = _hold(jops.separable_conv, tops.separable_conv,
                [image, vert, horiz], (0, 1, 2), "separable_conv")
    assert out.shape == (2, 3, h - fs + 1, w - fs + 1)
    with pytest.raises(ValueError, match="filters must be"):
        tops.separable_conv(nchw(image)[:, :, 1:], nchw(vert), nchw(horiz))


@pytest.mark.parametrize("fs,h,w", [(4, 9, 11), (5, 13, 17)])
def test_separable_conv_flow_matches_jax(fs, h, w):
    rng = np.random.RandomState(fs + 1)
    vert = rng.rand(2, h, w, fs).astype(np.float32)
    horiz = rng.rand(2, h, w, fs).astype(np.float32)
    vert[0, :2] = 0.0                    # sums to exactly 0: the sentinel
    horiz[1, 3, :4] = 0.0
    horiz[1, 4, 1, :2] = (1.0, -1.0)     # sums to 0 with nonzero taps
    horiz[1, 4, 1, 2:] = 0.0
    out = _hold(jops.separable_conv_flow, tops.separable_conv_flow,
                [vert, horiz], (0, 1), "separable_conv_flow")
    want = np.asarray(jops.separable_conv_flow(jnp.asarray(vert),
                                               jnp.asarray(horiz)))
    sentinel = want == -2000.0
    assert sentinel[0, :2, :, 1].all() and sentinel[1, 3, :4, 0].all()
    assert sentinel[1, 4, 1, 0]
    np.testing.assert_array_equal(nhwc(out) == -2000.0, sentinel)


def test_ops_export_what_jax_exports():
    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


# ---------------------------------------------------------------------------
# the layers, the loss and the meter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,factor", [(4, 6, 2), (3, 5, 4), (1, 7, 2)])
def test_upsample_align_corners_matches_jax(h, w, factor):
    x = np.random.RandomState(h).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(jax_upsample_ac(jnp.asarray(x), factor))
    got = nhwc(upsample_bilinear_align_corners(nchw(x), factor))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_replication_pad_matches_jax():
    x = np.random.RandomState(0).rand(2, 5, 7, 3).astype(np.float32)
    pads = (1, 3, 2, 0)
    want = np.asarray(jax_replication_pad(jnp.asarray(x), pads))
    np.testing.assert_array_equal(nhwc(replication_pad(nchw(x), pads)), want)


def test_smooth_loss_matches_jax():
    x = np.random.RandomState(1).randn(2, 9, 11, 2).astype(np.float32)
    want = float(jax_smooth_loss(jnp.asarray(x), 1e-6))
    np.testing.assert_allclose(float(smooth_loss(nchw(x), 1e-6)), want,
                               rtol=1e-6)


def test_running_mean_matches_jax():
    stream = [(3.0, 2), (5.5, 0), (-1.0, 1), (2.0, 0.5), (7.0, 0), (4.25, 3)]
    ours, theirs = RunningMean(), JaxRunningMean()
    for value, n in stream:
        ours.update(value, n)
        theirs.update(value, n)
        assert (ours.mean, ours.weight, ours.last) == (
            theirs.mean, theirs.weight, theirs.last)
    assert ours.val == 4.25 and ours.avg == theirs.avg
    empty = AverageMeter()
    empty.update(9.0, 0)                  # n = 0 records `last` only
    assert (empty.mean, empty.weight, empty.last) == (0.0, 0.0, 9.0)
    empty.reset()
    assert (empty.mean, empty.weight, empty.last) == (0.0, 0.0, 0.0)
