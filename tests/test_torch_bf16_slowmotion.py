"""The port's bf16 DAIN_slowmotion against the JAX package's bf16 lane, on
the CPU: ``DAINSlowMotion(0.5, compute_dtype="bfloat16")`` at 64x64 against
JAX's ``DAINSlowMotion(0.5, compute_dtype="bfloat16", rect_impl="fused")``
(its fused trunk in interpret mode), on seeded port weights carried over by
the key map.  Frames, rectified frames and filters with the lane tolerance
and criterion of tests/torch_lane.py; the offsets, float32 in both lanes
(MegaDepth, PWC-Net and the depth projection stay float32), at the float32
tolerance of tests/test_torch_slowmotion.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_lane import check_lane, jax_variables, nchw, nhwc, tame  # noqa: E402
from vfidkr_tpu.models import DAINSlowMotion as JaxDAINSlowMotion  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.models import DAINSlowMotion  # noqa: E402

H = W = 64


@pytest.fixture(scope="module")
def slowmo_lanes():
    rng = np.random.RandomState(1)
    i0 = rng.rand(1, H, W, 3).astype(np.float32)
    i2 = rng.rand(1, H, W, 3).astype(np.float32)
    port = DAINSlowMotion(0.5, generator=torch.Generator().manual_seed(1),
                          compute_dtype="bfloat16")
    tame(port, seed=1)
    args = (jax_variables(port), jnp.asarray(i0), jnp.asarray(i2))
    want_f32 = jax.device_get(jax.jit(JaxDAINSlowMotion(0.5).apply)(*args))
    want_bf16 = jax.device_get(jax.jit(JaxDAINSlowMotion(
        0.5, compute_dtype="bfloat16", rect_impl="fused").apply)(*args))
    kernels.reset_launches()
    with torch.inference_mode():
        got = port(nchw(i0), nchw(i2))
    launches = dict(kernels.LAUNCHES)
    return port, got, want_bf16, want_f32, launches


@pytest.mark.parametrize("k,name", [(0, "outputs"), (1, "rectified")])
def test_slowmo_bf16_frames_match_jax_lane(slowmo_lanes, k, name):
    _, got, want_bf16, want_f32, _ = slowmo_lanes
    frames = got["outputs"][k]
    assert len(frames) == len(want_bf16["outputs"][k]) == 1
    assert frames[0].dtype == torch.float32
    check_lane(name, nhwc(frames[0]), want_bf16["outputs"][k][0],
               want_f32["outputs"][k][0])


@pytest.mark.parametrize("k", [0, 1])
def test_slowmo_bf16_filters_match_jax_lane(slowmo_lanes, k):
    _, got, want_bf16, want_f32, _ = slowmo_lanes
    check_lane(f"filters[{k}]", nhwc(got["filters"][k]),
               want_bf16["filters"][k], want_f32["filters"][k])


def test_slowmo_bf16_offsets_stay_float32(slowmo_lanes):
    _, got, want_bf16, _, _ = slowmo_lanes
    assert np.abs(nhwc(got["offsets"][0])).max() > 0.1  # non-trivial flows
    for a, b in zip(got["offsets"], want_bf16["offsets"]):
        np.testing.assert_allclose(nhwc(a), b, rtol=1e-3, atol=2e-4)


def test_slowmo_bf16_launches_nothing_on_cpu_and_is_eval_only(slowmo_lanes):
    port, _, _, _, launches = slowmo_lanes
    assert all(n == 0 for n in launches.values()), launches
    assert port.ctxNet.block1[0].compute_dtype == torch.bfloat16
    assert port.depthNet.training is False
    with pytest.raises(NotImplementedError, match="evaluation only"):
        port.train()
