"""DAIN's vestigial children in the port: OccNet and DeconvField against the
JAX package's modules on converted JAX parameters (64x64, forward within
1e-5 x max(1, |JAX|); the parameter trees' shapes traced by
``jax.eval_shape`` and their values seeded draws scaled as a fan-in init,
which skips flax's eager init), the weight bridge (vfidkr_torch.convert)
with and without the vestigial subtrees, exact both ways, a reference-layout state
dict loaded with ``strict=True``, ``DAIN(init_unused=True)`` bit for bit
against ``init_unused=False`` at one seed, the optimizer groups, one train
step, and a checkpoint written without the children resumed.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfidkr_tpu.convert.inverse import \
    invert_dain_state_dict as jax_invert  # noqa: E402
from vfidkr_tpu.convert.torch_loader import \
    convert_dain_state_dict as jax_convert  # noqa: E402
from vfidkr_tpu.models.dain import DAIN as JaxDAIN  # noqa: E402
from vfidkr_tpu.models.mononet import DeconvField as JaxDeconvField  # noqa: E402
from vfidkr_tpu.models.mononet import OccNet as JaxOccNet  # noqa: E402

from vfidkr_torch.convert import (load_jax_variables,  # noqa: E402
                                  reference_state_dict)
from vfidkr_torch.models import DAIN, DAINSlowMotion  # noqa: E402
from vfidkr_torch.models.dain import VESTIGIAL  # noqa: E402
from vfidkr_torch.models.mononet import DeconvField, OccNet  # noqa: E402
from vfidkr_torch.training import (TrainConfig, full_state,  # noqa: E402
                                   make_optimizer, plateau_init,
                                   restore_full_state, train_step)

H = W = 64
JAX_CHILDREN = ("occ_net", "deconv_field", "ctx_net")


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


def _vestigial_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith(VESTIGIAL)}


def _draw(shapes, rng):
    """Seeded values for a traced variable tree: kernels at a fan-in scale,
    biases small."""
    def leaf(path, s):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.randn(*s.shape) * 0.01).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _traced(model_j, *args):
    return jax.eval_shape(lambda *a: model_j.init(jax.random.PRNGKey(0), *a),
                          *[jax.ShapeDtypeStruct(a.shape, jnp.float32)
                            for a in args])


@pytest.mark.parametrize("name", ["initOcclusion", "initDeconv_field"])
def test_vestigial_net_matches_jax(name):
    rng = np.random.RandomState(1)
    if name == "initOcclusion":
        model_j, port, flax_name = JaxOccNet(), OccNet(), "occ_net"
        x = rng.rand(1, H, W, 6).astype(np.float32)
    else:
        model_j, port, flax_name = JaxDeconvField(32), DeconvField(32), \
            "deconv_field"
        x = rng.rand(1, H, W, 3).astype(np.float32)
    params = _draw(_traced(model_j, x), rng)
    want = np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.add_module(name, port)
    loaded = load_jax_variables(holder, {"params": {flax_name:
                                                    params["params"]}})
    assert len(loaded) == len(port.state_dict())
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape
    assert want.std() > 1e-3                  # neither flat nor saturated
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= 1e-5, err


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX DAIN(init_unused=True) variable tree: its shapes traced, its
    values a seeded draw."""
    x = np.zeros((1, H, W, 3), np.float32)
    return _draw(_traced(JaxDAIN(), x, x), np.random.RandomState(0))


@pytest.fixture(scope="module")
def dain_pair():
    """DAIN at seed 0 with and without the vestigial children; tests that
    change a model take a copy."""
    return (DAIN(generator=torch.Generator().manual_seed(0)).eval(),
            DAIN(generator=torch.Generator().manual_seed(0),
                 init_unused=False).eval())


def test_round_trip_with_the_vestigial_children(jax_tree, dain_pair):
    port = copy.deepcopy(dain_pair[0])
    loaded = load_jax_variables(port, jax_tree)
    assert len(loaded) == len(port.state_dict()) == 225
    assert sum(k.startswith(VESTIGIAL) for k in loaded) == 57
    sd = {k: v.numpy() for k, v in reference_state_dict(port).items()}
    back = _flat(jax_convert(sd)["params"])
    want = _flat(jax_tree["params"])
    assert {p[0] for p in want} >= set(JAX_CHILDREN)
    # the JAX converter reads PWC-Net's unused deconv2 besides
    assert set(back) - set(want) == {("flownets", "deconv2", "deconv", k)
                                     for k in ("kernel", "bias")}
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))


def test_round_trip_without_the_vestigial_children(jax_tree, dain_pair):
    tree = {"params": {k: v for k, v in jax_tree["params"].items()
                       if k not in JAX_CHILDREN}}
    port = copy.deepcopy(dain_pair[0])
    init = _vestigial_state(port)
    loaded = load_jax_variables(port, tree)
    assert len(loaded) == 168
    after = _vestigial_state(port)
    assert len(init) == 57 and all(torch.equal(after[k], v)
                                   for k, v in init.items())
    sd = {k: v.numpy() for k, v in reference_state_dict(port).items()
          if not k.startswith(VESTIGIAL)}
    back = _flat(jax_convert(sd)["params"])
    for path, value in _flat(tree["params"]).items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
    # only the vestigial children may be missing
    del tree["params"]["rectify_net"]
    with pytest.raises(KeyError, match="rectifyNet"):
        load_jax_variables(port, tree)


def test_reference_layout_state_dict_loads_strict(jax_tree, dain_pair):
    port = copy.deepcopy(dain_pair[0])
    template = {k: v.numpy() for k, v in reference_state_dict(port).items()}
    sd, missing = jax_invert(jax_tree, template)
    # PWC-Net's deconv2, which nothing calls, is the one reference key that
    # no model of either package holds
    assert sorted(missing) == ["flownets.deconv2.bias",
                               "flownets.deconv2.weight"]
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_init_unused_changes_no_weight_or_output(dain_pair):
    a, b = dain_pair
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) - set(sb) == {k for k in sa if k.startswith(VESTIGIAL)}
    assert all(torch.equal(sa[k], v) for k, v in sb.items())
    assert a.vestigial == VESTIGIAL and b.vestigial == ()
    assert DAINSlowMotion().vestigial == ()
    g = torch.Generator().manual_seed(2)
    i0, i2 = torch.rand(1, 3, H, W, generator=g), torch.rand(
        1, 3, H, W, generator=g)
    with torch.inference_mode():
        oa, ob = a(i0, i2), b(i0, i2)
    for key in ("outputs", "offsets", "filters"):
        for x, y in zip(oa[key], ob[key]):
            assert torch.equal(x, y), key


def test_train_step_leaves_the_vestigial_children_alone(dain_pair):
    model = copy.deepcopy(dain_pair[0])
    opt = make_optimizer(model, TrainConfig())
    grouped = {id(p) for g in opt.param_groups for p in g["params"]}
    for child in VESTIGIAL:
        params = list(getattr(model, child).parameters())
        assert params and not any(id(p) in grouped or p.requires_grad
                                  for p in params), child
    before = _vestigial_state(model)
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.rand(1, 3, H, W, generator=g) for k in ("x0", "x1", "y")}
    train_step(model, opt, batch, TrainConfig())
    after = _vestigial_state(model)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(p.grad is None for child in VESTIGIAL
               for p in getattr(model, child).parameters())


def _stepped(model):
    """``model`` and its optimizer after one Adamax step on unit gradients,
    so the optimizer's state is not empty."""
    opt = make_optimizer(model, TrainConfig())
    for group in opt.param_groups:
        for p in group["params"]:
            p.grad = torch.ones_like(p)
    opt.step()
    return opt


def test_checkpoint_without_the_vestigial_children_resumes(dain_pair):
    """A checkpoint of a model built without the children (as every
    checkpoint written before DAIN built them), as ``CheckpointManager``
    holds it, resumes into ``DAIN()``."""
    old = copy.deepcopy(dain_pair[1])
    state = full_state(old, _stepped(old), plateau_init(), 1, 0.25)
    new = copy.deepcopy(dain_pair[0])
    init = _vestigial_state(new)
    opt = make_optimizer(new, TrainConfig())
    plateau = restore_full_state(state, new, opt)
    assert plateau == plateau_init()
    sd = new.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in state["model"].items())
    assert all(torch.equal(sd[k], v) for k, v in init.items())
    assert all(len(opt.state[p]) > 0 for g in opt.param_groups
               for p in g["params"])
    # any other missing key, or an unexpected one, still raises
    broken = dict(state, model={k: v for k, v in state["model"].items()
                                if not k.startswith("rectifyNet.block5")})
    with pytest.raises(RuntimeError, match="rectifyNet.block5"):
        restore_full_state(broken, new, opt)
    extra = dict(state, model={**state["model"], "extra.weight":
                               torch.zeros(1)})
    with pytest.raises(RuntimeError, match="extra.weight"):
        restore_full_state(extra, new, opt)
