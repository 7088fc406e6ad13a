"""Helpers of the bf16-lane tests (tests/test_torch_bf16*.py): layouts,
seeded port weights carried to the JAX package, and the lane criterion.
Run as a script, it prints the lane's gap to the float32 forward (``gap``
below).

Tolerance of the bf16 lane, port against JAX's lane on the same inputs:
|port - jax_bf16| <= 2^-6 x max|jax_f32| (two bf16 ulps of the tensor's
largest magnitude).  Both lanes round each bf16 conv's output, but their
sums run in another order, so a rounding flips now and then and the chain
of convs carries the flips on: an element's difference follows the scale of
the activations, not its own value.  Beside it, the lane criterion: the
port's max error against the JAX float32 forward is at most 1.5 x the JAX
bf16 lane's own max error against it.
"""
import numpy as np
import torch

LANE_TOL = 2.0 ** -6
GAP_FACTOR = 1.5


def nchw(a):
    """NHWC numpy/JAX array -> NCHW float32 torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC float32 numpy array."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def tame(model, seed=0):
    """Seeded port weights made tame as chip_smoke.py makes them: all x0.5,
    biases jittered, the flow head's bias set to a (5.3, -3.1) px move so
    that projection and warp shift pixels."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.mul_(0.5)
            if name.endswith("bias"):
                p.add_((torch.rand(p.shape, generator=g) - 0.5) * 0.02)
        model.flownets.dc_conv7.bias.add_(torch.tensor([0.53, -0.31]))
    return model


def jax_variables(model):
    """The port's weights as the JAX package's variable tree (the port's
    copy of the key map; PWC-Net's unused deconv2 as zeros)."""
    from vfidkr_torch.convert import _PWC_DECONV2, convert_dain_state_dict
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    sd.update({k: np.zeros(s, np.float32) for k, s in _PWC_DECONV2.items()})
    return convert_dain_state_dict(sd)


def lane_errors(got, want_bf16, want_f32):
    """(max |port - jax bf16|, its bound, port's max error against JAX
    f32, JAX bf16's max error against JAX f32), all NHWC float32."""
    got, want_bf16, want_f32 = (np.asarray(a, np.float32)
                                for a in (got, want_bf16, want_f32))
    assert got.shape == want_f32.shape and np.all(np.isfinite(got))
    return (float(np.abs(got - want_bf16).max()),
            LANE_TOL * float(np.abs(want_f32).max()),
            float(np.abs(got - want_f32).max()),
            float(np.abs(want_bf16 - want_f32).max()))


def check_lane(name, got, want_bf16, want_f32):
    """The lane tolerance and the lane criterion (module doc)."""
    err, tol, gap_port, gap_jax = lane_errors(got, want_bf16, want_f32)
    assert err <= tol, f"{name}: |port - jax bf16| {err} > {tol}"
    assert gap_jax > 0, f"{name}: the JAX lanes agree exactly"
    assert gap_port <= GAP_FACTOR * gap_jax, (
        f"{name}: port vs f32 {gap_port} > {GAP_FACTOR} x jax bf16 vs f32 "
        f"{gap_jax}")


def gap(a, b):
    """Max and mean |a - b| and the PSNR of a against b (peak 1)."""
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return (f"max {d.max():.4e} mean {d.mean():.4e} "
            f"PSNR {10 * np.log10(1.0 / float(np.mean(d * d))):.2f} dB")


def main():
    """The bf16 lane's gap to the float32 forward, for the JAX package and
    the port, on the CPU: DAIN and DAINSlowMotion(0.5) at 64x64 on the
    seeded, tamed port weights of tests/test_torch_bf16*.py, the JAX lane
    with its fused rectifier trunk in interpret mode.  Per output: max and
    mean |bf16 - f32| and the PSNR of the bf16 output against the float32
    one, for JAX's lane and the port's.

        JAX_PLATFORMS=cpu python tests/torch_lane.py
    """
    import jax
    import jax.numpy as jnp
    from vfidkr_tpu.models import DAIN as JaxDAIN
    from vfidkr_tpu.models import DAINSlowMotion as JaxDAINSlowMotion
    from vfidkr_torch.models import DAIN, DAINSlowMotion

    h = w = 64
    for name, seed, port_cls, jax_cls, kw in (
            ("DAIN", 0, DAIN, JaxDAIN, {"init_unused": False}),
            ("DAINSlowMotion(0.5)", 1, lambda **k: DAINSlowMotion(0.5, **k),
             lambda **k: JaxDAINSlowMotion(0.5, **k), {})):
        rng = np.random.RandomState(seed)
        i0 = rng.rand(1, h, w, 3).astype(np.float32)
        i2 = rng.rand(1, h, w, 3).astype(np.float32)
        port = tame(port_cls(generator=torch.Generator().manual_seed(seed),
                             compute_dtype="bfloat16"), seed=seed)
        args = (jax_variables(port), jnp.asarray(i0), jnp.asarray(i2))
        f32 = jax.device_get(jax.jit(jax_cls(**kw).apply)(*args))
        bf16 = jax.device_get(jax.jit(jax_cls(
            compute_dtype="bfloat16", rect_impl="fused", **kw).apply)(*args))
        with torch.inference_mode():
            got = port(nchw(i0), nchw(i2))
        for key, k in (("outputs", 0), ("outputs", 1), ("filters", 0)):
            want, lane, mine = f32[key][k], bf16[key][k], got[key][k]
            if isinstance(want, list):          # slow motion: step 0
                want, lane, mine = want[0], lane[0], mine[0]
            print(f"{name} {key}[{k}]: JAX bf16 vs f32 {gap(lane, want)}; "
                  f"port bf16 vs JAX f32 {gap(nhwc(mine), want)}")


if __name__ == "__main__":
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
