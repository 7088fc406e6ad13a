"""The port's bf16 eval lane against the JAX package's, on the CPU.

* ``fused_resblocks_plain`` (the plain version of the kernel K4) against
  ``vfidkr_tpu.ops.pallas.rectify_kernel.fused_resblocks`` in interpret
  mode (as tests/test_resblock_fused.py runs it), on the inputs of that
  test, within 2^-6 x max(1, max|jax|): the two sum each conv in another
  order, a bf16 rounding flips now and then and the six convs carry the
  flips on, so the difference follows the activations' scale, not each
  element's value;
* the bf16 rectifier (45 channels in) against JAX's ``MultipleBasicBlock(
  impl="fused")`` under ``conv_compute_dtype(bfloat16)``, and MonoNet5 with
  its heads against JAX's in the lane, each with the lane tolerance and
  criterion of tests/torch_lane.py;
* ``DAIN(compute_dtype="bfloat16")`` at 64x64 against JAX's ``DAIN(
  compute_dtype="bfloat16", rect_impl="fused")`` on seeded port weights
  carried over by the key map: filters and frames with the lane tolerance
  and criterion; the offsets, float32 in both lanes (PWC-Net and the
  projection stay float32), at the float32 tolerance of
  tests/test_torch_dain.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_lane import (LANE_TOL, check_lane, jax_variables, nchw,  # noqa: E402
                        nhwc, tame)
from vfidkr_tpu.models import DAIN as JaxDAIN  # noqa: E402
from vfidkr_tpu.models.layers import conv_compute_dtype  # noqa: E402
from vfidkr_tpu.models.mononet import BranchHead as JaxBranchHead  # noqa: E402
from vfidkr_tpu.models.mononet import MonoNet5 as JaxMonoNet5  # noqa: E402
from vfidkr_tpu.models.resblock import (  # noqa: E402
    MultipleBasicBlock as JaxMultipleBasicBlock)
from vfidkr_tpu.ops.pallas.rectify_kernel import (  # noqa: E402
    fused_resblocks as jax_fused_resblocks)

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.models import (DAIN, BranchHead, MonoNet5,  # noqa: E402
                                 MultipleBasicBlock)
from vfidkr_torch.ops.rectify import (fused_resblocks,  # noqa: E402
                                      fused_resblocks_plain)

H = W = 64
BF16 = torch.bfloat16


def _port(**children):
    """A container whose children sit under the names the DAIN state_dict
    gives them, so the converter's key map applies unchanged."""
    m = torch.nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m.eval()


@pytest.mark.parametrize("shape", [(1, 16, 24, 128), (1, 64, 64, 128)])
def test_fused_resblocks_plain_matches_jax(rng, shape):
    x = jnp.asarray(rng.randn(*shape) * 0.5, jnp.bfloat16)
    w6 = jnp.asarray(rng.randn(6, 3, 3, 128, 128) * 0.05, jnp.bfloat16)
    want = np.asarray(jax_fused_resblocks(x, w6), np.float32)
    xt = nchw(np.asarray(x, np.float32)).to(BF16)
    wt = torch.from_numpy(np.ascontiguousarray(
        np.asarray(w6, np.float32).transpose(0, 4, 3, 1, 2))).to(BF16)
    got = fused_resblocks_plain(xt, wt)
    assert got.dtype == BF16
    err = np.abs(nhwc(got) - want)
    assert err.max() <= LANE_TOL * max(1.0, np.abs(want).max()), err.max()
    assert np.abs(want).max() > 4.0
    # the wrapper takes the plain version on the CPU, and launches nothing
    before = dict(kernels.LAUNCHES)
    assert torch.equal(fused_resblocks(xt, wt), got)
    assert kernels.LAUNCHES == before


def test_fused_resblocks_rejects_bad_shapes():
    x = torch.zeros(1, 64, 8, 8, dtype=BF16)
    with pytest.raises(ValueError, match="x must be"):
        fused_resblocks(x, torch.zeros(6, 128, 128, 3, 3, dtype=BF16))
    with pytest.raises(ValueError, match="w6 must be"):
        fused_resblocks(torch.zeros(1, 128, 8, 8, dtype=BF16),
                        torch.zeros(6, 128, 128, 1, 1, dtype=BF16))


def _jax_lanes(module_j, variables, *args, bf16_module=None):
    want_f32 = module_j.apply(variables, *args)
    with conv_compute_dtype(jnp.bfloat16):
        want_bf16 = (bf16_module or module_j).apply(variables, *args)
    return want_f32, want_bf16


def test_rectifier_bf16_matches_jax(rng):
    """The float32 reference is the chained rectifier on the same
    parameters (the fused trunk is the bf16 lane's)."""
    x = rng.rand(1, 32, 48, 45).astype(np.float32)
    rect_j = JaxMultipleBasicBlock(4, 128, impl="chained")
    params = rect_j.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want_f32, want_bf16 = _jax_lanes(
        rect_j, params, jnp.asarray(x),
        bf16_module=JaxMultipleBasicBlock(4, 128, impl="fused"))
    port = _port(rectifyNet=MultipleBasicBlock(45, 128, compute_dtype=BF16))
    load_jax_variables(port, jax.device_get(
        {"params": {"rectify_net": params["params"]}}))
    with torch.no_grad():
        got = port.rectifyNet(nchw(x))
    assert got.dtype == BF16 and want_bf16.dtype == jnp.bfloat16
    check_lane("rectifier", nhwc(got), want_bf16, want_f32)


def test_mononet_and_heads_bf16_match_jax(rng):
    x = rng.rand(1, H, W, 6).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    trunk_j, head_j = JaxMonoNet5(), JaxBranchHead(16)
    p_trunk = trunk_j.init(k1, jnp.asarray(x))
    p_head = head_j.init(k2, trunk_j.apply(p_trunk, jnp.asarray(x)))
    trunk_f32, trunk_bf16 = _jax_lanes(trunk_j, p_trunk, jnp.asarray(x))
    head_f32 = head_j.apply(p_head, trunk_f32)
    with conv_compute_dtype(jnp.bfloat16):
        head_bf16 = head_j.apply(p_head, trunk_bf16)
    port = _port(initScaleNets_filter=MonoNet5(compute_dtype=BF16),
                 initScaleNets_filter1=BranchHead(compute_dtype=BF16))
    load_jax_variables(port, jax.device_get({"params": {
        "filter_net": p_trunk["params"], "filter_head1": p_head["params"]}}))
    with torch.no_grad():
        trunk = port.initScaleNets_filter(nchw(x))
        head = port.initScaleNets_filter1(trunk)
    assert trunk.dtype == head.dtype == BF16
    check_lane("MonoNet5", nhwc(trunk), trunk_bf16, trunk_f32)
    check_lane("BranchHead", nhwc(head), head_bf16, head_f32)


@pytest.fixture(scope="module")
def dain_lanes():
    rng = np.random.RandomState(0)
    i0 = rng.rand(1, H, W, 3).astype(np.float32)
    i2 = rng.rand(1, H, W, 3).astype(np.float32)
    port = DAIN(generator=torch.Generator().manual_seed(0),
                compute_dtype="bfloat16")
    tame(port)
    variables = jax_variables(port)
    args = (variables, jnp.asarray(i0), jnp.asarray(i2))
    want_f32 = jax.device_get(jax.jit(JaxDAIN(init_unused=False).apply)(
        *args))
    want_bf16 = jax.device_get(jax.jit(JaxDAIN(
        init_unused=False, compute_dtype="bfloat16",
        rect_impl="fused").apply)(*args))
    kernels.reset_launches()
    with torch.inference_mode():
        got = port(nchw(i0), nchw(i2))
    launches = dict(kernels.LAUNCHES)
    return port, got, want_bf16, want_f32, launches


@pytest.mark.parametrize("key,k", [("outputs", 0), ("outputs", 1),
                                   ("filters", 0), ("filters", 1)])
def test_dain_bf16_matches_jax_lane(dain_lanes, key, k):
    _, got, want_bf16, want_f32, _ = dain_lanes
    assert got[key][k].dtype == torch.float32
    check_lane(f"{key}[{k}]", nhwc(got[key][k]), want_bf16[key][k],
               want_f32[key][k])


@pytest.mark.parametrize("k", [0, 1])
def test_dain_bf16_offsets_stay_float32(dain_lanes, k):
    _, got, want_bf16, _, _ = dain_lanes
    off = nhwc(got["offsets"][k])
    assert np.abs(off).max() > 0.1             # the flows are not trivial
    np.testing.assert_allclose(off, want_bf16["offsets"][k], rtol=1e-3,
                               atol=1e-4)


def test_dain_bf16_is_eval_only_and_launches_nothing_on_cpu(dain_lanes):
    port, _, _, _, launches = dain_lanes
    assert all(n == 0 for n in launches.values()), launches
    assert not port.training and port.rectifyNet.compute_dtype == BF16
    with pytest.raises(NotImplementedError, match="evaluation only"):
        port.train()
    port.eval()
    assert DAIN().training                         # float32 trains as before
    with pytest.raises(ValueError, match="compute_dtype"):
        DAIN(compute_dtype="float16")
