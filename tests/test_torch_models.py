"""The port's networks against the JAX package's at 64x64 (the smallest
frame PWC-Net takes), with the JAX weights carried over by
``vfidkr_torch.convert.load_jax_variables``.  Inputs are made with numpy
from a seed; the port is NCHW, the JAX package NHWC.

Tolerance: relative 1e-4 of the output's own scale (absolute 1e-4 x its
largest magnitude, a few hundred float32 ulps): the two frameworks sum each
convolution in another order, and a deep chain of them (PWC-Net's 5-level
decoder with warps) carries that rounding forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfidkr_tpu.models.mononet import BranchHead as JaxBranchHead  # noqa: E402
from vfidkr_tpu.models.mononet import MonoNet5 as JaxMonoNet5  # noqa: E402
from vfidkr_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet  # noqa: E402
from vfidkr_tpu.models.resblock import (  # noqa: E402
    MultipleBasicBlock as JaxMultipleBasicBlock)

from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.models import (BranchHead, MonoNet5,  # noqa: E402
                                 MultipleBasicBlock, PWCDCNet)

H = W = 64


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_close(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _port(**children):
    """A container whose children sit under the names the DAIN state_dict
    gives them, so the converter's key map applies unchanged."""
    m = torch.nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m.eval()


def test_mononet_and_heads_match_jax(rng):
    x = rng.rand(1, H, W, 6).astype(np.float32)
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    trunk_j = JaxMonoNet5()
    head_j = JaxBranchHead(16)
    p_trunk = trunk_j.init(k1, jnp.asarray(x))
    trunk_out = trunk_j.apply(p_trunk, jnp.asarray(x))
    p_h1 = head_j.init(k2, trunk_out)
    p_h2 = head_j.init(k3, trunk_out)
    variables = jax.device_get({"params": {
        "filter_net": p_trunk["params"], "filter_head1": p_h1["params"],
        "filter_head2": p_h2["params"]}})

    port = _port(initScaleNets_filter=MonoNet5(),
                 initScaleNets_filter1=BranchHead(),
                 initScaleNets_filter2=BranchHead())
    loaded = load_jax_variables(port, variables)
    assert len(loaded) == 2 * (12 + 2 + 2)
    with torch.no_grad():
        trunk = port.initScaleNets_filter(nchw(x))
        f1 = port.initScaleNets_filter1(trunk)
        f2 = port.initScaleNets_filter2(trunk)
    assert_close(nhwc(trunk), trunk_out)
    assert_close(nhwc(f1), head_j.apply(p_h1, trunk_out))
    assert_close(nhwc(f2), head_j.apply(p_h2, trunk_out))


def test_pwcnet_bidirectional_matches_jax(rng):
    i0 = rng.rand(1, H, W, 3).astype(np.float32)
    i2 = rng.rand(1, H, W, 3).astype(np.float32)
    pwc_j = JaxPWCDCNet()
    params = pwc_j.init(jax.random.PRNGKey(1), jnp.asarray(i0),
                        jnp.asarray(i2), method=JaxPWCDCNet.bidirectional)
    fwd_j, bwd_j = pwc_j.apply(params, jnp.asarray(i0), jnp.asarray(i2),
                               method=JaxPWCDCNet.bidirectional)

    port = _port(flownets=PWCDCNet())
    load_jax_variables(port, jax.device_get(
        {"params": {"flownets": params["params"]}}))
    with torch.no_grad():
        fwd, bwd = port.flownets.bidirectional(nchw(i0), nchw(i2))
        fwd_single = port.flownets(nchw(i0), nchw(i2))
    assert fwd.shape == (1, 2, H // 4, W // 4)
    assert_close(nhwc(fwd), fwd_j)
    assert_close(nhwc(bwd), bwd_j)
    # the shared-pyramid batched pass is the plain two-frame pass, up to
    # the rounding of convolutions run at another batch size
    np.testing.assert_allclose(fwd.numpy(), fwd_single.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rectifier_matches_jax(rng):
    x = rng.rand(1, H, W, 45).astype(np.float32)
    rect_j = JaxMultipleBasicBlock(4, 128, impl="chained")
    params = rect_j.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = rect_j.apply(params, jnp.asarray(x))

    port = _port(rectifyNet=MultipleBasicBlock(45, 128))
    loaded = load_jax_variables(port, jax.device_get(
        {"params": {"rectify_net": params["params"]}}))
    assert len(loaded) == 2 + 6 + 2
    with torch.no_grad():
        got = port.rectifyNet(nchw(x))
    assert_close(nhwc(got), want)


def test_load_jax_variables_rejects_missing_keys():
    """Every port key must get a value from the JAX tree."""
    port = _port(rectifyNet=MultipleBasicBlock(45, 128))
    with pytest.raises(KeyError):
        load_jax_variables(port, {"params": {}})


def test_seeded_init_is_reproducible():
    a = MultipleBasicBlock(45, 8, generator=torch.Generator().manual_seed(3))
    b = MultipleBasicBlock(45, 8, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
