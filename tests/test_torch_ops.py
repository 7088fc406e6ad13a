"""The port's ops (vfidkr_torch.ops, plain PyTorch on the CPU) against the
JAX package's ops on the same inputs, made with numpy from a seed.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode, called through the same internals their tests call.  The
port is NCHW and the JAX package NHWC; ``nchw``/``nhwc`` convert at the
comparison.  Tolerances: 1e-5 absolute for float32 results whose sums run in
another order; hit counts and hole-fill selections exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import golden  # noqa: E402
import vfidkr_tpu.ops.flow_projection as P  # noqa: E402
from vfidkr_tpu.models.layers import upsample_bilinear as jax_upsample  # noqa: E402
from vfidkr_tpu.ops import correlation_cost_volume as jax_corr  # noqa: E402
from vfidkr_tpu.ops import filter_interpolate as jax_filter_interpolate  # noqa: E402
from vfidkr_tpu.ops import flow_project as jax_flow_project  # noqa: E402
from vfidkr_tpu.ops import pwc_warp as jax_pwc_warp  # noqa: E402
from vfidkr_tpu.ops.filter_interpolation import _filter_interpolate_slab  # noqa: E402
from vfidkr_tpu.ops.pallas.fillhole_kernel import fill_holes_pallas  # noqa: E402
from vfidkr_tpu.ops.pallas.projection_band_kernel import scatter4_band_pallas  # noqa: E402

from vfidkr_torch.models.layers import upsample_bilinear  # noqa: E402
from vfidkr_torch.ops import (correlation_cost_volume, fill_holes,  # noqa: E402
                              filter_interpolate, flow_project, pwc_warp)
from vfidkr_torch.ops.flow_projection import finalize, scatter4  # noqa: E402

ATOL = 1e-5


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# filter_interpolate (kernel K1's plain version)
# ---------------------------------------------------------------------------

def _filter_case(rng, b=2, h=16, w=32, c=3):
    image = rng.rand(b, h, w, c).astype(np.float32)
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 12).astype(np.float32)
    filt = rng.randn(b, h, w, 16).astype(np.float32)
    # exact borders: x2 == W-1 and y2 == H-1 are valid (inclusive bounds)
    flow[0, 4, w - 4] = (3.0, 0.5)
    flow[0, h - 3, 6] = (0.25, 2.0)
    flow[1, h - 1, w - 1] = (0.0, 0.0)
    # |fx| >= W/2 with an in-frame landing: invalid, copies the source
    flow[0, 2, 0] = (w / 2, 0.0)
    flow[1, 3, 1] = (w / 2 - 0.5, 0.0)       # just inside: valid
    flow[1, 5, 20] = (0.0, -(h / 2))
    # out of the frame: invalid
    flow[0, 7, 3] = (-40.0, 0.0)
    flow[1, 9, 30] = (0.0, 9.0)
    flow[0, 0, 0] = (-0.5, 0.0)
    return image, flow, filt


@pytest.fixture
def filter_case(rng):
    image, flow, filt = _filter_case(rng)
    got = nhwc(filter_interpolate(nchw(image), nchw(flow), nchw(filt)))
    return image, flow, filt, got


def test_filter_interpolate_matches_jax_block(filter_case):
    image, flow, filt, got = filter_case
    want = jax_filter_interpolate(jnp.asarray(image), jnp.asarray(flow),
                                  jnp.asarray(filt), impl="block")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_filter_interpolate_matches_golden(filter_case):
    image, flow, filt, got = filter_case
    for i in range(image.shape[0]):
        want = golden.filter_interpolate_fwd(image[i], flow[i], filt[i])
        np.testing.assert_allclose(got[i], want, rtol=0, atol=ATOL)


def test_filter_interpolate_matches_pallas_kernel(filter_case):
    """``filter_bandmm_pallas`` (interpret mode) through its caller, as
    tests/test_ops_filter_slab.py runs it."""
    image, flow, filt, got = filter_case
    want = _filter_interpolate_slab(jnp.asarray(image), jnp.asarray(flow),
                                    jnp.asarray(filt), 4, 16, image.shape[2])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_filter_interpolate_invalid_pixels_copy_source(filter_case):
    image, flow, _, got = filter_case
    for (b, y, x) in [(0, 2, 0), (1, 5, 20), (0, 7, 3), (1, 9, 30), (0, 0, 0)]:
        np.testing.assert_array_equal(got[b, y, x], image[b, y, x])


def test_filter_interpolate_generic_channels(rng):
    """C is a runtime size (the 196-channel context warp reuses the op)."""
    image, flow, filt = _filter_case(rng, c=7)
    got = nhwc(filter_interpolate(nchw(image), nchw(flow), nchw(filt)))
    want = jax_filter_interpolate(jnp.asarray(image), jnp.asarray(flow),
                                  jnp.asarray(filt), impl="gather")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("bad", ["flow", "filt", "image"])
def test_filter_interpolate_rejects_bad_shapes(bad):
    image, flow, filt = (torch.zeros(1, 3, 8, 8), torch.zeros(1, 2, 8, 8),
                         torch.zeros(1, 16, 8, 8))
    args = {"image": image, "flow": flow, "filt": filt}
    args[bad] = {"flow": flow[:, :1], "filt": filt[:, :9], "image": image[0]}[bad]
    with pytest.raises(ValueError):
        filter_interpolate(**args)


# ---------------------------------------------------------------------------
# flow projection: scatter (K2), finalize + fill (K3), end to end
# ---------------------------------------------------------------------------

def _proj_flow(rng, b=2, h=16, w=32, scale=5.0):
    return ((rng.rand(b, h, w, 2) - 0.5) * 2 * scale).astype(np.float32)


def _border_flow(h=16, w=32):
    """Every pixel lands beyond the last row, or on it, or on the last
    column: both neighbours clamp to one cell, which gets two adds."""
    flow = np.zeros((1, h, w, 2), np.float32)
    flow[0, :, :, 1] = 2.25
    flow[0, h - 1, :, 1] = 0.0
    flow[0, :, w - 1, 0] = 0.0
    flow[0, 3, w - 2] = (1.0, 0.0)            # x2 == W-1 exactly
    return flow


@pytest.mark.parametrize("case", ["random", "border"])
def test_scatter4_matches_pallas_kernel(rng, case):
    """The plain scatter against ``scatter4_band_pallas`` (interpret mode)
    on the JAX package's own landing prep; the count exactly."""
    flow = _proj_flow(rng) if case == "random" else _border_flow()
    iy_t, iy_b, ix_l, ix_r, vals = jax.vmap(P._scatter_prep)(jnp.asarray(flow))
    want = np.asarray(scatter4_band_pallas(iy_t, iy_b, ix_l, ix_r, vals,
                                           band=16, tw=32))
    got = nhwc(scatter4(nchw(flow)))
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=ATOL)
    if case == "border":
        assert got[..., 2].max() >= 8.0       # double adds stack up


def _holes_case(rng, b=3, h=16, w=32):
    cnt = ((rng.rand(b, h, w) > 0.6) * rng.randint(1, 5, (b, h, w))
           ).astype(np.float32)
    cnt[0, 5, :] = 0.0                        # an all-hole row
    cnt[0, :, 11] = 0.0                       # an all-hole column
    cnt[2] = 0.0                              # an all-hole field
    out = (rng.randn(b, h, w, 2) * (cnt[..., None] > 0)).astype(np.float32)
    return cnt, out


def test_fill_holes_matches_pallas_kernel(rng):
    cnt, out = _holes_case(rng)
    got = nhwc(fill_holes(torch.from_numpy(cnt), nchw(out)))
    want = fill_holes_pallas(jnp.asarray(cnt), jnp.asarray(out))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    assert np.abs(got[2]).max() == 0.0


def test_fill_holes_matches_golden(rng):
    cnt, out = _holes_case(rng)
    got = nhwc(fill_holes(torch.from_numpy(cnt), nchw(out)))
    for i in range(cnt.shape[0]):
        np.testing.assert_allclose(got[i], golden.fill_holes_ref(cnt[i], out[i]),
                                   rtol=0, atol=ATOL)


def test_finalize_averages_and_fills(rng):
    """The count average followed by the fill, from scatter sums."""
    cnt, out = _holes_case(rng)
    acc = np.concatenate([out * np.maximum(cnt, 1)[..., None],
                          cnt[..., None]], -1)
    got = nhwc(finalize(nchw(acc)))
    want = jax.vmap(P.fill_holes)(jnp.asarray(cnt), jnp.asarray(out))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["random", "border"])
def test_flow_project_matches_jax(rng, case):
    flow = _proj_flow(rng, scale=8.0) if case == "random" else _border_flow()
    got = nhwc(flow_project(nchw(flow), hole_fill=True))
    want = jax_flow_project(jnp.asarray(flow), hole_fill=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    for i in range(flow.shape[0]):
        want_g, _ = golden.flow_project_fwd(flow[i], fill=True)
        np.testing.assert_allclose(got[i], want_g, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# plain ops of PWC-Net and the upsample
# ---------------------------------------------------------------------------

def test_correlation_matches_jax(rng):
    f1 = rng.randn(2, 8, 12, 7).astype(np.float32)
    f2 = rng.randn(2, 8, 12, 7).astype(np.float32)
    got = nhwc(correlation_cost_volume(nchw(f1), nchw(f2), 4))
    want = jax_corr(jnp.asarray(f1), jnp.asarray(f2), 4)
    assert got.shape == (2, 8, 12, 81)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[0], golden.correlation_fwd(f1[0], f2[0]),
                               rtol=0, atol=ATOL)


def test_pwc_warp_matches_jax(rng):
    h, w = 8, 16
    image = rng.randn(2, h, w, 5).astype(np.float32)
    flow = ((rng.rand(2, h, w, 2) - 0.5) * 6).astype(np.float32)
    # the 0.9999 mask edge: gx = (x + fx) * W/(W-1) - 0.5; at x = W-1 the
    # right tap is out of the frame with weight frac(gx)
    flow[0, 2, w - 1] = ((w - 1 + 0.5 + 5e-5) * (w - 1) / w - (w - 1), 0.0)
    flow[0, 3, w - 1] = ((w - 1 + 0.5 + 2e-4) * (w - 1) / w - (w - 1), 0.0)
    flow[1, 0, 0] = (0.0, -0.4)
    got = nhwc(pwc_warp(nchw(image), nchw(flow)))
    want = np.asarray(jax_pwc_warp(jnp.asarray(image), jnp.asarray(flow)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got[0, 2, w - 1]).max() > 0       # out weight 5e-5: kept
    assert np.abs(got[0, 3, w - 1]).max() == 0      # out weight 2e-4: masked


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_bilinear_matches_jax(rng, factor):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    got = nhwc(upsample_bilinear(nchw(x), factor))
    want = jax_upsample(jnp.asarray(x), factor)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
