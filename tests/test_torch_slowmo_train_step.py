"""One DAIN_slowmotion train step of the port (plain PyTorch on the CPU)
against the JAX package's ``train_step``, on the same weights and batch.

``DAINSlowMotion(0.5)`` at 64x64, B=1, weights tamed as the other
slow-motion tests tame them (all x0.5, biases jittered, MegaDepth's BN
statistics too) and carried over by ``load_jax_variables``.  JAX's step runs
with its default freeze of the context and depth nets; its optimizer is
replaced by a probe that reads the gradient out.  The port freezes the same
nets through ``make_optimizer``.

Tolerances: the loss terms to rtol 1e-4; each grouped gradient leaf within
rtol 5e-3 and atol 5e-3 x the leaf's largest magnitude, as
tests/test_full_graph_backward.py holds the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vfidkr_tpu.convert import convert_dain_state_dict  # noqa: E402
from vfidkr_tpu.models import DAINSlowMotion as JaxDAINSlowMotion  # noqa: E402
from vfidkr_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from vfidkr_tpu.training import plateau_init as jax_plateau_init  # noqa: E402
from vfidkr_tpu.training import train_step as jax_train_step  # noqa: E402
from vfidkr_tpu.training.checkpoint import flatten_tree  # noqa: E402
from vfidkr_tpu.training.train_state import TrainState  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.models import DAINSlowMotion  # noqa: E402
from vfidkr_torch.training import TrainConfig, make_optimizer, train_step  # noqa: E402
from vfidkr_torch.training.train_state import FROZEN, GROUPS  # noqa: E402

H = W = 64
# JAX's top-level parameter names of the grouped port children
_GROUPED_JAX = ("filter_net", "filter_head1", "filter_head2", "flownets",
                "rectify_net")


def nchw(a):
    """NHWC numpy array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _tame(tree, rng, name=""):
    """All weights x0.5; biases jittered so the flows are non-trivial."""
    if isinstance(tree, dict):
        return {k: _tame(v, rng, k) for k, v in tree.items()}
    v = np.asarray(tree, np.float32) * 0.5
    if name == "bias":
        v = v + ((rng.rand(*v.shape) - 0.5) * 0.02).astype(np.float32)
    return v


def _grad_probe():
    """An optax transformation whose state is the last gradient and whose
    update is zero: it reads the gradient out of ``train_step``."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        init=zeros, update=lambda u, s, p=None: (zeros(u), u))


@pytest.fixture(scope="module")
def step_pair():
    rng = np.random.RandomState(0)
    batch = {k: rng.rand(1, H, W, 3).astype(np.float32)
             for k in ("x0", "x1", "y")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model_j = JaxDAINSlowMotion(timestep=0.5)
    variables = _tame(jax.device_get(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jbatch["x0"], jbatch["x1"])), rng)
    probe = _grad_probe()
    state = TrainState(step=jnp.asarray(0), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=probe.init(variables["params"]),
                       plateau=jax_plateau_init())
    new_state, metrics_j = jax.jit(
        lambda s, b: jax_train_step(model_j, probe, s, b, JaxTrainConfig()))(
            state, jbatch)
    grads_j = jax.device_get(new_state.opt_state)

    port = DAINSlowMotion(0.5)
    load_jax_variables(port, variables)
    opt = make_optimizer(port, TrainConfig())
    before = {k: v.clone() for k, v in port.state_dict().items()}
    kernels.reset_launches()
    metrics = train_step(port, opt, {k: nchw(v) for k, v in batch.items()},
                         TrainConfig())
    launches = dict(kernels.LAUNCHES)
    grads = {k: p.grad for k, p in port.named_parameters()}
    after = port.state_dict()
    return {"metrics_j": jax.device_get(metrics_j), "grads_j": grads_j,
            "metrics": metrics, "grads": grads, "before": before,
            "after": after, "launches": launches, "port": port}


def test_slowmo_train_step_loss_matches_jax(step_pair):
    metrics, metrics_j = step_pair["metrics"], step_pair["metrics_j"]
    for key in ("total", "tv", "sym", "psnr"):
        np.testing.assert_allclose(float(metrics[key]), float(metrics_j[key]),
                                   rtol=1e-4, err_msg=key)
    assert metrics["pixel"].shape == (2,)
    np.testing.assert_allclose(metrics["pixel"].numpy(),
                               np.asarray(metrics_j["pixel"]), rtol=1e-4)
    assert all(n == 0 for n in step_pair["launches"].values())


def test_slowmo_train_step_grads_match_jax(step_pair):
    """Every grouped gradient leaf, mapped to the JAX tree by the weight
    converter; the frozen nets get no gradient on either side."""
    grads, grads_j = step_pair["grads"], step_pair["grads_j"]
    frozen = [k for k in grads if k.startswith(FROZEN)]
    assert frozen and all(grads[k] is None for k in frozen)
    for name in ("ctx_net", "depth_net"):
        assert all(not np.any(np.asarray(leaf))
                   for leaf in jax.tree_util.tree_leaves(grads_j[name])), name
    sd = {k: g.numpy() for k, g in grads.items() if g is not None}
    sd.update({"flownets.deconv2.weight": np.zeros((2, 2, 4, 4), np.float32),
               "flownets.deconv2.bias": np.zeros((2,), np.float32)})
    gflat = flatten_tree(convert_dain_state_dict(sd)["params"])
    jflat = {p: g for p, g in flatten_tree(grads_j).items()
             if p[0] in _GROUPED_JAX}
    compared = 0
    for path, jg in jflat.items():
        tg = np.asarray(gflat[path], np.float32)
        jg = np.asarray(jg, np.float32)
        assert tg.shape == jg.shape, path
        scale = max(np.abs(tg).max(), np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(tg, jg, rtol=5e-3, atol=5e-3 * scale,
                                   err_msg=str(path))
        compared += 1
    grouped = [k for k in grads
               if k.startswith(sum(GROUPS.values(), ()))]
    assert compared == len(grouped) == len(grads) - len(frozen)


def test_slowmo_train_step_moves_groups_not_frozen_nets(step_pair):
    """Every grouped parameter whose gradient is not negligible against
    Adamax's eps moves; the frozen nets' parameters and MegaDepth's BN
    buffers stay bit for bit, and MegaDepth stayed in eval mode."""
    before, after, grads = (step_pair[k] for k in ("before", "after",
                                                   "grads"))
    for prefix in sum(GROUPS.values(), ()):
        keys = [k for k in grads if k.split(".")[0] == prefix
                and np.abs(grads[k].numpy()).max() > 1e-6]
        assert keys and all(not torch.equal(before[k], after[k])
                            for k in keys), prefix
    kept = [k for k in before if k.startswith(FROZEN)]
    assert any(k.endswith("running_var") for k in kept)
    for k in kept:
        assert torch.equal(before[k], after[k]), k
    port = step_pair["port"]
    assert port.training and not port.depthNet.training
    assert not any(m.training for m in port.depthNet.modules())
