"""The parts of the port's DAIN_slowmotion forward (vfidkr_torch, plain
PyTorch on the CPU) against the JAX package's, on the same inputs made with
numpy from a seed: S2DF, MegaDepth, the depth-weighted flow projection and
the 196-channel context warp.

The JAX side runs as its own tests run it on the CPU: its Pallas context
kernel in interpret mode, called through ``_filter_interpolate_ctx`` at the
small band parameters of tests/test_ops_filter_ctx.py.  The port is NCHW,
the JAX package NHWC.  Tolerances: 1e-5 for float32 sums in another order;
MegaDepth's log-depth to rtol 2e-5, atol 2e-6, the tolerance of the JAX
package's own MegaDepth variant tests (tests/test_models_shapes.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vfidkr_tpu.ops.flow_projection as P  # noqa: E402
from vfidkr_tpu.models.megadepth import (  # noqa: E402
    MegaDepthHourglass as JaxMegaDepth)
from vfidkr_tpu.models.s2df import S2DF as JaxS2DF  # noqa: E402
from vfidkr_tpu.ops import depth_flow_project as jax_depth_flow_project  # noqa: E402
from vfidkr_tpu.ops import filter_interpolate as jax_filter_interpolate  # noqa: E402
from vfidkr_tpu.ops.filter_interpolation import _filter_interpolate_ctx  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.models import S2DF, MegaDepthHourglass  # noqa: E402
from vfidkr_torch.ops import depth_flow_project, filter_interpolate  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402

H = W = 64


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _port(name, child):
    """A container that puts ``child`` under its DAIN_slowmotion name, so
    the converter's key map applies unchanged."""
    m = torch.nn.Module()
    m.add_module(name, child)
    return m.eval()


# ---------------------------------------------------------------------------
# S2DF and MegaDepth
# ---------------------------------------------------------------------------

def test_s2df_matches_jax(rng):
    x = rng.rand(1, H, W, 3).astype(np.float32)
    model_j = JaxS2DF(3, True, True)
    params = jax.device_get(model_j.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    port = S2DF()
    loaded = load_jax_variables(_port("ctxNet", port),
                                {"params": {"ctx_net": params["params"]}})
    assert len(loaded) == len(port.state_dict()) == 5
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == (1, H, W, 195)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def megadepth_pair():
    rng = np.random.RandomState(1)
    x = rng.rand(1, H, W, 3).astype(np.float32)
    model_j = JaxMegaDepth()
    variables = jax.device_get(jax.jit(model_j.init)(jax.random.PRNGKey(0),
                                                     jnp.asarray(x)))
    for stats in variables["batch_stats"].values():    # not the defaults
        stats["mean"] = (rng.randn(*stats["mean"].shape) * 0.1).astype(
            np.float32)
        stats["var"] = (0.5 + rng.rand(*stats["var"].shape)).astype(
            np.float32)
    want = np.asarray(jax.jit(model_j.apply)(variables, jnp.asarray(x)))
    port = MegaDepthHourglass()
    loaded = load_jax_variables(_port("depthNet", port), {
        "params": {"depth_net": variables["params"]},
        "batch_stats": {"depth_net": variables["batch_stats"]}})
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    return variables, port, loaded, want, got


def test_megadepth_matches_jax(megadepth_pair):
    _, _, _, want, got = megadepth_pair
    assert got.shape == (1, H, W, 1) and np.ptp(want) > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_megadepth_keys_are_the_jax_names(megadepth_pair):
    """Every state_dict key but the BN counters is one flax leaf
    ``n_<path>/<leaf>``, and every flax leaf is one key."""
    variables, port, loaded, _, _ = megadepth_pair
    leaf = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}
    mapped = set()
    for key, value in port.state_dict().items():
        *idx, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        coll, flax_leaf = leaf[name]
        if name == "weight" and value.dim() == 1:
            flax_leaf = "scale"                      # affine BN
        node = variables[coll]["n_" + "_".join(idx)]
        assert node[flax_leaf].size == value.numel(), key
        mapped.add((coll, "n_" + "_".join(idx), flax_leaf))
    flax_leaves = {(coll, node, lf) for coll in ("params", "batch_stats")
                   for node, leaves in variables[coll].items()
                   for lf in leaves}
    assert mapped == flax_leaves
    assert len(loaded) == len(mapped) == 624


def test_megadepth_running_stats_come_across(megadepth_pair):
    variables, port, _, _, _ = megadepth_pair
    sd = port.state_dict()
    for name, stats in variables["batch_stats"].items():
        key = ".".join(name.split("_")[1:])
        np.testing.assert_array_equal(sd[f"{key}.running_mean"].numpy(),
                                      stats["mean"])
        np.testing.assert_array_equal(sd[f"{key}.running_var"].numpy(),
                                      stats["var"])


# ---------------------------------------------------------------------------
# the depth-weighted flow projection (kernels K2 with a weight, and K3)
# ---------------------------------------------------------------------------

def _depth_case(rng, b=2, h=32, w=48):
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 16).astype(np.float32)
    flow[0, 3:6, 2:5] = (-20.0, 0.0)             # off the frame: no landing
    flow[1, h - 4:, 10:14] = (0.0, 9.0)
    flow[0, 8, w - 3] = (2.0, 0.0)               # x2 == W-1: border double-add
    flow[1, h - 2, 5] = (0.0, 1.0)               # y2 == H-1
    depth_inv = (1e-6 + np.exp(-rng.uniform(-1, 3, (b, h, w)))).astype(
        np.float32)
    return flow, depth_inv


def test_weighted_scatter_matches_jax(rng):
    flow, depth_inv = _depth_case(rng)
    iy_t, iy_b, ix_l, ix_r, vals = jax.vmap(P._depth_prep)(
        jnp.asarray(flow), jnp.asarray(depth_inv))
    want = np.asarray(P._scatter4(iy_t, iy_b, ix_l, ix_r, vals))
    got = nhwc(FP.scatter4(nchw(flow), torch.from_numpy(depth_inv)))
    assert want[..., 2].max() > 1.0                  # cells sum several hits
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hole_fill", [False, True])
def test_finalize_plain_is_the_depth_average(rng, hole_fill):
    """K3's plain version (and ``_count_average`` for the unfilled
    projection) on a weighted accumulator is JAX's depth average."""
    flow, depth_inv = _depth_case(rng)
    final, out, _ = P._depth_flow_project_fwd(
        jnp.asarray(flow), jnp.asarray(depth_inv), hole_fill)
    acc = FP.scatter4_plain(nchw(flow), torch.from_numpy(depth_inv))
    assert bool((acc[:, 2] <= 0).any())              # there are holes
    got = FP.finalize_plain(acc) if hole_fill else FP._count_average(acc)
    np.testing.assert_allclose(nhwc(got), np.asarray(final),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(FP._count_average(acc)), np.asarray(out),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hole_fill", [False, True])
def test_depth_flow_project_matches_jax(rng, hole_fill):
    flow, depth_inv = _depth_case(rng)
    want = jax_depth_flow_project(jnp.asarray(flow), jnp.asarray(depth_inv),
                                  hole_fill=hole_fill)
    kernels.reset_launches()
    got = depth_flow_project(nchw(flow), torch.from_numpy(depth_inv)[:, None],
                             hole_fill=hole_fill)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    np.testing.assert_allclose(nhwc(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["flow", "depth_inv"])
def test_depth_flow_project_raises_where_a_gradient_is_needed(rng, which):
    """The reference's depth backward is not the autodiff of the forward:
    the bare weighted scatter refuses to record one and raises, and
    ``depth_flow_project`` records the reference's (held to JAX's in
    tests/test_torch_depth_grad.py)."""
    flow, depth_inv = _depth_case(rng)
    flow, depth_inv = nchw(flow), torch.from_numpy(depth_inv)
    {"flow": flow, "depth_inv": depth_inv}[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        FP.scatter4(flow, depth_inv)
    for hole_fill in (False, True):
        out = depth_flow_project(flow, depth_inv, hole_fill=hole_fill)
        assert out.grad_fn is not None and out.shape == flow.shape
    with torch.no_grad():
        assert depth_flow_project(flow, depth_inv).shape == flow.shape


# ---------------------------------------------------------------------------
# the 196-channel context warp (kernel K7's plain version)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx_case():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 32, 64, 196
    image = rng.rand(b, h, w, c).astype(np.float32)
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 12).astype(np.float32)
    filt = rng.rand(b, h, w, 16).astype(np.float32)
    flow[0, 8, 8] = (500.0, 0.0)               # invalid: copies all channels
    flow[1, 3, 0] = (w / 2, 0.0)               # |fx| == W/2: invalid
    flow[1, 20, w - 5] = (4.0, 0.0)            # x2 == W-1: valid
    kernels.reset_launches()
    got = nhwc(filter_interpolate(nchw(image), nchw(flow), nchw(filt)))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    return image, flow, filt, got


def test_ctx_warp_matches_jax_block(ctx_case):
    image, flow, filt, got = ctx_case
    want = jax_filter_interpolate(jnp.asarray(image), jnp.asarray(flow),
                                  jnp.asarray(filt), impl="block")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ctx_warp_matches_jax_ctx_kernel(ctx_case):
    image, flow, filt, got = ctx_case
    want = _filter_interpolate_ctx(jnp.asarray(image), jnp.asarray(flow),
                                   jnp.asarray(filt), 4, 16, 32, 10, 14, 40)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ctx_warp_copies_invalid_pixels(ctx_case):
    image, _, _, got = ctx_case
    np.testing.assert_array_equal(got[0, 8, 8], image[0, 8, 8])
    np.testing.assert_array_equal(got[1, 3, 0], image[1, 3, 0])
    assert not np.array_equal(got[1, 20, 64 - 5], image[1, 20, 64 - 5])
