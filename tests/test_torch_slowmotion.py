"""The port's DAIN_slowmotion eval forward against the JAX package's, and
the weight bridge for its variable tree.

The full-graph comparison runs at 64x64, B=1 (the smallest frame PWC-Net
takes), at timestep 0.5 (one frame) and 0.25 (three frames), with the JAX
weights tamed as tests/test_torch_dain.py tames them (all x0.5, biases
jittered) and carried over by ``load_jax_variables``.  Every output,
rectified output, offset and filter is held to rtol 1e-3, atol 2e-4 (the
tolerance of tests/test_torch_dain.py's frames).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfidkr_tpu.convert import invert_dain_state_dict as jax_invert  # noqa: E402
from vfidkr_tpu.models import DAINSlowMotion as JaxDAINSlowMotion  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.convert import (_PWC_DECONV2, invert_dain_state_dict,  # noqa: E402
                                  load_jax_variables)
from vfidkr_torch.models import DAINSlowMotion  # noqa: E402

H = W = 64
RTOL, ATOL = 1e-3, 2e-4


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _tame(tree, rng, name=""):
    """All weights x0.5; biases jittered so the flows are non-trivial."""
    if isinstance(tree, dict):
        return {k: _tame(v, rng, k) for k, v in tree.items()}
    v = np.asarray(tree, np.float32) * 0.5
    if name == "bias":
        v = v + ((rng.rand(*v.shape) - 0.5) * 0.02).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def frames_and_variables():
    """One tamed variable tree (it does not depend on the timestep)."""
    rng = np.random.RandomState(0)
    i0 = rng.rand(1, H, W, 3).astype(np.float32)
    i2 = rng.rand(1, H, W, 3).astype(np.float32)
    init = jax.jit(JaxDAINSlowMotion(timestep=0.5).init)
    variables = _tame(jax.device_get(init(
        jax.random.PRNGKey(0), jnp.asarray(i0), jnp.asarray(i2))), rng)
    return i0, i2, variables


@pytest.fixture(scope="module", params=[0.5, 0.25])
def slowmo_pair(request, frames_and_variables):
    i0, i2, variables = frames_and_variables
    timestep = request.param
    apply = jax.jit(JaxDAINSlowMotion(timestep=timestep).apply)
    want = jax.device_get(apply(variables, jnp.asarray(i0), jnp.asarray(i2)))
    port = DAINSlowMotion(timestep=timestep)
    loaded = load_jax_variables(port, variables)
    kernels.reset_launches()
    with torch.inference_mode():
        got = port(nchw(i0), nchw(i2))
    launches = dict(kernels.LAUNCHES)
    return timestep, want, got, loaded, launches


def _check(got, want):
    got = nhwc(got)
    assert got.shape == np.shape(want) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,name", [(0, "outputs"), (1, "rectified")])
def test_slowmo_frames_match_jax(slowmo_pair, k, name):
    timestep, want, got, _, _ = slowmo_pair
    frames = got["outputs"][k]
    assert len(frames) == len(want["outputs"][k]) == round(1 / timestep) - 1
    for step, (a, b) in enumerate(zip(frames, want["outputs"][k])):
        assert a.shape == (1, 3, H, W), (name, step)
        _check(a, b)


def test_slowmo_offsets_and_filters_match_jax(slowmo_pair):
    _, want, got, _, _ = slowmo_pair
    assert np.abs(nhwc(got["offsets"][0])).max() > 0.1   # non-trivial flows
    for key in ("offsets", "filters"):
        for a, b in zip(got[key], want[key]):
            _check(a, b)


def test_slowmo_loads_every_weight_and_launches_no_kernel(slowmo_pair):
    """On CPU tensors every op takes its plain version; every key but the
    BN counters comes from the JAX tree."""
    _, _, _, loaded, launches = slowmo_pair
    sd = DAINSlowMotion().state_dict()
    counters = [k for k in sd if k.endswith("num_batches_tracked")]
    assert len(counters) == 155
    assert sorted(loaded) == sorted(set(sd) - set(counters))
    assert set(launches) == set(kernels.KERNELS)
    assert all(n == 0 for n in launches.values()), launches


def test_slowmo_train_mode_raises():
    """A model starts in eval mode.  ``train()`` raises in the bf16 lane,
    which is evaluation only; in float32 it trains, with MegaDepth kept on
    its running statistics (tests/test_torch_slowmo_trainer.py)."""
    model = DAINSlowMotion()
    assert not model.training and not model.depthNet.training
    with pytest.raises(NotImplementedError, match="evaluation only"):
        DAINSlowMotion(compute_dtype="bfloat16").train()
    model.train()
    assert model.training and not model.depthNet.training
    model.eval()


def test_weight_bridge_matches_jax_converter(frames_and_variables):
    """The port's own copy of the inverse converter gives JAX's
    ``invert_dain_state_dict`` result bit for bit."""
    _, _, variables = frames_and_variables
    template = {k: v.numpy() for k, v in DAINSlowMotion().state_dict().items()}
    template.update({k: np.zeros(s, np.float32)
                     for k, s in _PWC_DECONV2.items()})
    got, got_missing = invert_dain_state_dict(variables, template)
    want, want_missing = jax_invert(variables, template)
    assert got_missing == want_missing
    assert len(got_missing) == 155 + len(_PWC_DECONV2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
