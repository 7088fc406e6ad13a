"""The port's training path (vfidkr_torch, plain PyTorch on the CPU) against
the JAX package's, on the same inputs made with numpy from a seed.

Covered: the gradients of the two ops that hold kernels (filter
interpolation and the train flow projection) against ``jax.vjp``, with the
JAX side's Pallas backward kernels in interpret mode as its own tests run
them; the repairs of the port's gradient faults; the losses, the plateau
schedule and the Adamax update; one DAIN train step at 64x64 against JAX's
``train_step``; checkpoints, resume and the trainer.

Tolerances: 1e-5 absolute for float32 sums in another order (rtol 1e-4 for
gradients, which sum more terms); the DAIN gradients per leaf with rtol 5e-3
and atol 5e-3 x the leaf's largest magnitude, as
tests/test_full_graph_backward.py holds the reference's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import vfidkr_tpu.ops.flow_projection as P  # noqa: E402
import vfidkr_tpu.training.loss as JL  # noqa: E402
from vfidkr_tpu.convert import convert_dain_state_dict  # noqa: E402
from vfidkr_tpu.models import DAIN as JaxDAIN  # noqa: E402
from vfidkr_tpu.ops import filter_interpolate as jax_filter_interpolate  # noqa: E402
from vfidkr_tpu.ops import flow_project as jax_flow_project  # noqa: E402
from vfidkr_tpu.ops.filter_interpolation import _filter_interpolate_slab  # noqa: E402
from vfidkr_tpu.ops.pallas.projection_band_kernel import scatter4_bwd_pallas  # noqa: E402
from vfidkr_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from vfidkr_tpu.training import make_optimizer as jax_make_optimizer  # noqa: E402
from vfidkr_tpu.training import plateau_init as jax_plateau_init  # noqa: E402
from vfidkr_tpu.training import plateau_step as jax_plateau_step  # noqa: E402
from vfidkr_tpu.training import train_step as jax_train_step  # noqa: E402
from vfidkr_tpu.training.checkpoint import flatten_tree  # noqa: E402
from vfidkr_tpu.training.train_state import TrainState  # noqa: E402

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.apps import train as train_app  # noqa: E402
from vfidkr_torch.convert import load_jax_variables  # noqa: E402
from vfidkr_torch.models import DAIN  # noqa: E402
from vfidkr_torch.ops import filter_interpolation as FI  # noqa: E402
from vfidkr_torch.ops import flow_projection as FP  # noqa: E402
from vfidkr_torch.training import (CheckpointManager, TrainConfig,  # noqa: E402
                                   filtered_partial_load, make_optimizer,
                                   plateau_init, plateau_step, train_step)
from vfidkr_torch.training import loss as TL  # noqa: E402
from vfidkr_torch.training.train_state import set_lr_scale  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nchw(a):
    """NHWC numpy/JAX array -> NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    """NCHW torch tensor -> NHWC numpy array."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _grads(fn, *arrays, cotangent):
    """Port gradients of ``fn`` w.r.t. NHWC ``arrays`` under ``cotangent``,
    returned NHWC."""
    ts = [nchw(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    gs = torch.autograd.grad(out, ts, nchw(cotangent))
    return [nhwc(g) for g in gs]


# ---------------------------------------------------------------------------
# the repairs: no gradient through an invalid pixel's copy or the hole
# fill; a kernel wrapper joins the graph or raises
# ---------------------------------------------------------------------------

def test_invalid_pixels_pass_no_gradient_to_image():
    """Every pixel lands out of the frame: the forward copies the source,
    and the image takes no gradient from it, as in JAX."""
    image = np.random.RandomState(0).rand(1, 8, 8, 3).astype(np.float32)
    flow = np.full((1, 8, 8, 2), 8.0, np.float32)
    filt = np.ones((1, 8, 8, 16), np.float32)
    g = np.ones((1, 8, 8, 3), np.float32)
    got = _grads(FI.filter_interpolate, image, flow, filt, cotangent=g)
    _, vjp = jax.vjp(lambda *a: jax_filter_interpolate(*a, impl="block"),
                     jnp.asarray(image), jnp.asarray(flow), jnp.asarray(filt))
    want = vjp(jnp.asarray(g))
    assert np.abs(np.asarray(want[0])).sum() == 0.0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_hole_filled_projection_passes_no_gradient():
    flow = np.random.RandomState(1).randn(1, 8, 8, 2).astype(np.float32) * 3
    t = nchw(flow).requires_grad_()
    out = FP.flow_project(t, hole_fill=True)
    assert not out.requires_grad
    want = jax.grad(lambda f: jnp.sum(jax_flow_project(f, hole_fill=True)))(
        jnp.asarray(flow))
    assert np.abs(np.asarray(want)).sum() == 0.0


@pytest.fixture
def fake_kernels(monkeypatch):
    """Route kernel launches to a recorder: meta tensors then take the CUDA
    wrappers' path on this machine, with no data."""
    calls = []
    monkeypatch.setattr(kernels, "check_inputs", lambda name, *ts: None)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    return calls


def test_kernel_wrappers_join_the_graph_or_raise(fake_kernels):
    meta = lambda *s: torch.zeros(*s, device="meta")
    image, flow, filt = meta(1, 3, 8, 8), meta(1, 2, 8, 8), meta(1, 16, 8, 8)

    flow.requires_grad_()
    filt.requires_grad_()
    out = FI.filter_interpolate(image, flow, filt)
    assert out.grad_fn is not None
    out.backward(torch.ones_like(out))
    assert flow.grad.shape == flow.shape and filt.grad.shape == filt.shape
    assert image.grad is None
    (fwd, _), (bwd, args) = fake_kernels
    assert (fwd, bwd) == ("filter_interpolate_fwd", "filter_interpolate_bwd")
    assert args[4] is None          # no image gradient: the scatter skipped

    image.requires_grad_()
    FI.filter_interpolate(image, flow, filt).sum().backward()
    assert fake_kernels[-1][1][4] is not None and image.grad is not None

    acc = FP.scatter4(flow)
    assert acc.grad_fn is not None
    acc.sum().backward()
    assert fake_kernels[-1][0] == "flow_project_scatter_bwd"

    with pytest.raises(RuntimeError, match="no backward"):
        FP.finalize(meta(1, 3, 8, 8).requires_grad_())
    fake_kernels.clear()
    assert not FP.flow_project(flow, hole_fill=True).requires_grad
    assert [c[0] for c in fake_kernels] == ["flow_project_scatter",
                                           "flow_project_finalize"]

    fake_kernels.clear()
    with torch.no_grad():
        assert FI.filter_interpolate(image, flow, filt).grad_fn is None
    with torch.inference_mode():
        assert FP.scatter4(flow).grad_fn is None
    assert [c[0] for c in fake_kernels] == ["filter_interpolate_fwd",
                                           "flow_project_scatter"]


def _plain_launch(name, *args):
    """Each kernel's contract, computed by the plain versions on the CPU."""
    if name == "filter_interpolate_fwd":
        image, flow, filt, out = args[:4]
        out.copy_(FI.filter_interpolate_plain(image, flow, filt))
    elif name == "filter_interpolate_bwd":
        image, flow, filt, g, gimage, gflow, gfilt = args[:7]
        ins = [t.detach().requires_grad_() for t in (image, flow, filt)]
        with torch.enable_grad():
            gi, gf, gk = torch.autograd.grad(
                FI.filter_interpolate_plain(*ins), ins, g)
        if gimage is not None:
            gimage.add_(gi)
        gflow.copy_(gf)
        gfilt.copy_(gk)
    elif name == "flow_project_scatter":
        flow, acc = args[:2]
        acc.add_(FP.scatter4_plain(flow))
    elif name == "flow_project_scatter_bwd":
        flow, g, gflow = args[:3]
        f = flow.detach().requires_grad_()
        with torch.enable_grad():
            gflow.copy_(torch.autograd.grad(FP.scatter4_plain(f), f, g)[0])


def test_kernel_functions_route_gradients(monkeypatch, rng):
    """The autograd Functions around the kernels, driven on the CPU by the
    kernels' contracts: the same values and gradients as the plain ops."""
    monkeypatch.setattr(kernels, "check_inputs", lambda name, *ts: None)
    monkeypatch.setattr(kernels, "launch", _plain_launch)
    image, flow, filt = _filter_case(rng)
    g = rng.randn(*image.shape).astype(np.float32)
    want = _grads(FI.filter_interpolate_plain, image, flow, filt, cotangent=g)
    got = _grads(FI._FilterInterpolateKernel.apply, image, flow, filt,
                 cotangent=g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    flow = _proj_flow(rng)
    g = rng.randn(2, 16, 32, 3).astype(np.float32)
    want = _grads(FP.scatter4_plain, flow, cotangent=g)
    got = _grads(FP._Scatter4Kernel.apply, flow, cotangent=g)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# op gradients against jax.vjp
# ---------------------------------------------------------------------------

def _filter_case(rng, b=2, h=16, w=32, c=3):
    """Random flows up to 6 px, some landing out of the frame, none on an
    exact edge (see test_edge_landing_takes_twice_jax_flow_gradient)."""
    image = rng.rand(b, h, w, c).astype(np.float32)
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 12).astype(np.float32)
    filt = rng.randn(b, h, w, 16).astype(np.float32)
    flow[0, 7, 3] = (-40.0, 0.0)              # out of the frame
    flow[-1, 2, 0] = (w / 2, 0.0)             # |fx| == W/2: invalid
    return image, flow, filt


@pytest.mark.parametrize("jax_path", ["block", "slab_pallas"])
def test_filter_interpolate_vjp_matches_jax(rng, jax_path):
    """Gradients to image, flow and filter under a random cotangent; the
    slab path runs ``filter_bandmm_bwd_pallas`` in interpret mode."""
    image, flow, filt = _filter_case(rng)
    g = rng.randn(*image.shape).astype(np.float32)
    got = _grads(FI.filter_interpolate, image, flow, filt, cotangent=g)
    if jax_path == "block":
        fn = lambda *a: jax_filter_interpolate(*a, impl="block")
    else:
        fn = lambda *a: _filter_interpolate_slab(*a, 4, 16, image.shape[2])
    _, vjp = jax.vjp(fn, jnp.asarray(image), jnp.asarray(flow),
                     jnp.asarray(filt))
    want = vjp(jnp.asarray(g))
    for a, b, name in zip(got, want, ("image", "flow", "filt")):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_edge_landing_takes_twice_jax_flow_gradient(rng):
    """At x2 == W-1 the port's flow gradient is the reference's quadrant
    difference; JAX's ``jnp.clip`` halves it there.  Elsewhere they agree."""
    image, flow, filt = _filter_case(rng, b=1)
    w = image.shape[2]
    flow[0, 5, w - 4] = (3.0, 0.25)           # x2 == W-1 exactly
    g = rng.randn(*image.shape).astype(np.float32)
    got = _grads(FI.filter_interpolate, image, flow, filt, cotangent=g)[1]
    _, vjp = jax.vjp(lambda *a: jax_filter_interpolate(*a, impl="gather"),
                     jnp.asarray(image), jnp.asarray(flow), jnp.asarray(filt))
    want = np.asarray(vjp(jnp.asarray(g))[1])
    tie = (0, 5, w - 4, 0)
    assert abs(got[tie]) > 1e-3
    np.testing.assert_allclose(got[tie], 2.0 * want[tie], rtol=1e-5)
    mask = np.ones(got.shape, bool)
    mask[tie] = False
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-4, atol=1e-5)


def _proj_flow(rng, b=2, h=16, w=32, scale=5.0):
    return ((rng.rand(b, h, w, 2) - 0.5) * 2 * scale).astype(np.float32)


def _border_flow(h=16, w=32):
    """Landings on and beyond the last row and column: the two neighbours
    clamp to one cell, which is added to (and read back) twice."""
    flow = np.zeros((1, h, w, 2), np.float32)
    flow[0, :, :, 1] = 2.25
    flow[0, h - 1, :, 1] = 0.0
    flow[0, :, w - 1, 0] = 0.0
    flow[0, 3, w - 2] = (1.0, 0.0)
    return flow


@pytest.mark.parametrize("case", ["random", "border"])
def test_flow_project_train_vjp_matches_jax(rng, case):
    flow = _proj_flow(rng) if case == "random" else _border_flow()
    g = rng.randn(*flow.shape).astype(np.float32)
    fwd = nhwc(FP.flow_project(nchw(flow)))
    got = _grads(FP.flow_project, flow, cotangent=g)[0]
    out, vjp = jax.vjp(lambda f: jax_flow_project(f, hole_fill=False),
                       jnp.asarray(flow))
    np.testing.assert_allclose(fwd, np.asarray(out), rtol=0, atol=1e-5)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("jax_path", ["transpose", "pallas"])
@pytest.mark.parametrize("case", ["random", "border"])
def test_scatter4_vjp_matches_jax(rng, case, jax_path):
    """The scatter's backward under a random cotangent of its (N,3,H,W)
    sums, against JAX's: the XLA ``_scatter4_transpose``, or
    ``scatter4_bwd_pallas`` in interpret mode, chained to the flow as JAX
    chains it (``-valid * dvals``; the count carries no gradient)."""
    flow = _proj_flow(rng) if case == "random" else _border_flow()
    b, h, w, _ = flow.shape
    g = rng.randn(b, h, w, 3).astype(np.float32)
    got = _grads(FP.scatter4, flow, cotangent=g)[0]
    iy_t, iy_b, ix_l, ix_r, vals = jax.vmap(P._scatter_prep)(jnp.asarray(flow))
    if jax_path == "transpose":
        dvals = jax.vmap(P._scatter4_transpose)(iy_t, iy_b, ix_l, ix_r,
                                                jnp.asarray(g))
    else:
        dvals = scatter4_bwd_pallas(jnp.asarray(g), iy_t, iy_b, ix_l, ix_r,
                                    band=16, tw=32, rh=8)
    want = -np.asarray(vals)[..., 2:] * np.asarray(dvals)[..., :2]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# losses, plateau schedule, Adamax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["charbonnier_loss", "neg_psnr_loss",
                                  "tv_loss", "gra_adap_tv_loss",
                                  "motion_sym_loss", "part_loss",
                                  "total_loss", "psnr_from_diff"])
def test_loss_matches_jax(rng, name):
    eps = 1e-3
    x = (rng.rand(2, 8, 9, 3) - 0.5).astype(np.float32)
    flows = [rng.randn(2, 8, 9, 2).astype(np.float32) for _ in range(2)]
    imgs = [rng.rand(2, 8, 9, 3).astype(np.float32) for _ in range(2)]
    args = {
        "charbonnier_loss": lambda m, t: (t(x), eps),
        "neg_psnr_loss": lambda m, t: (t(x), eps),
        "tv_loss": lambda m, t: (t(x), eps),
        "gra_adap_tv_loss": lambda m, t: (t(flows[0]), t(imgs[0]), eps),
        "motion_sym_loss": lambda m, t: ([t(f) for f in flows], eps),
        "part_loss": lambda m, t: ([t(x), t(x * 0.5)],
                                   [t(f) for f in flows],
                                   [t(i) for i in imgs], eps),
        "total_loss": lambda m, t: ([m.charbonnier_loss(t(x), eps),
                                     m.tv_loss(t(x), eps)], (0.5, 2.0)),
        "psnr_from_diff": lambda m, t: (t(x),),
    }[name]
    got = getattr(TL, name)(*args(TL, nchw))
    want = getattr(JL, name)(*args(JL, jnp.asarray))
    got = np.array([float(v) for v in jax.tree_util.tree_leaves(got)])
    want = np.array([float(v) for v in jax.tree_util.tree_leaves(want)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_plateau_schedule_matches_jax():
    metrics = [1.0, 0.9, 0.8, 0.85, 0.82, 0.81, 0.80001, 0.7, 0.71, 0.72,
               0.73, 0.74, 0.69, 0.695]
    s, j = plateau_init(), jax_plateau_init()
    scales = []
    for m in metrics:
        s = plateau_step(s, m, factor=0.5, patience=2)
        j = jax_plateau_step(j, m, factor=0.5, patience=2)
        scales.append(s.scale)
        np.testing.assert_allclose(s.scale, float(j.scale), rtol=1e-6)
        assert s.num_bad_epochs == int(j.num_bad_epochs)
        np.testing.assert_allclose(s.best, float(j.best), rtol=1e-6)
    assert scales[-1] == 0.25                  # two reductions happened


class _Groups(torch.nn.Module):
    """Stand-ins under the DAIN children's names, one per optimizer group
    member."""

    def __init__(self, shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, torch.nn.ParameterDict(
                {"w": torch.nn.Parameter(torch.zeros(shape))}))


# port child -> JAX top-level parameter name
_CHILDREN = {"initScaleNets_filter": "filter_net",
             "initScaleNets_filter1": "filter_head1",
             "initScaleNets_filter2": "filter_head2",
             "flownets": "flownets", "rectifyNet": "rectify_net"}


def test_adamax_update_matches_optax(rng):
    """The three-group Adamax with the plateau scale against
    ``make_optimizer``'s optax update, fed the same gradients."""
    shapes = {name: (3 + i, 2) for i, name in enumerate(_CHILDREN)}
    init = {name: rng.randn(*s).astype(np.float32)
            for name, s in shapes.items()}
    kw = dict(lr=3e-3, rectify_lr=7e-4, filter_lr_coe=0.5, flow_lr_coe=0.1)
    model = _Groups(shapes)
    with torch.no_grad():
        for name, v in init.items():
            getattr(model, name)["w"].copy_(torch.from_numpy(v))
    opt = make_optimizer(model, TrainConfig(**kw))
    tx = jax_make_optimizer(JaxTrainConfig(**kw))
    params = {_CHILDREN[n]: {"w": jnp.asarray(v)} for n, v in init.items()}
    state = tx.init(params)
    for step, scale in enumerate([1.0, 1.0, 0.2]):
        grads = {n: rng.randn(*s).astype(np.float32) * 10.0 ** (step - 1)
                 for n, s in shapes.items()}
        set_lr_scale(opt, scale)
        for name, g in grads.items():
            getattr(model, name)["w"].grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update(
            {_CHILDREN[n]: {"w": jnp.asarray(g)} for n, g in grads.items()},
            state, params)
        updates = jax.tree_util.tree_map(lambda u: u * scale, updates)
        params = optax.apply_updates(params, updates)
        for name in shapes:
            got = getattr(model, name)["w"].detach().numpy()
            want = np.asarray(params[_CHILDREN[name]]["w"])
            moved = np.abs(want - init[name]).max()
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * moved, err_msg=name)


def test_optimizer_groups_cover_dain():
    model = DAIN()
    opt = make_optimizer(model, TrainConfig())
    names = [g["name"] for g in opt.param_groups]
    assert names == ["filter", "flow", "rectify"]
    assert [g["lr"] for g in opt.param_groups] == [2e-3, 2e-5, 1e-3]
    assert (sum(len(g["params"]) for g in opt.param_groups)
            == len(list(model.parameters())))


# ---------------------------------------------------------------------------
# one DAIN train step against JAX's train_step
# ---------------------------------------------------------------------------

H = W = 64


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
def train_step_pair():
    rng = np.random.RandomState(0)
    batch = {k: rng.rand(1, H, W, 3).astype(np.float32)
             for k in ("x0", "x1", "y")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model_j = JaxDAIN(init_unused=False)
    variables = _tame(jax.device_get(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jbatch["x0"], jbatch["x1"])), rng)
    probe = _grad_probe()
    config_j = JaxTrainConfig()
    state = TrainState(step=jnp.asarray(0), params=variables["params"],
                       batch_stats={}, opt_state=probe.init(
                           variables["params"]),
                       plateau=jax_plateau_init())
    new_state, metrics_j = jax.jit(
        lambda s, b: jax_train_step(model_j, probe, s, b, config_j))(
            state, jbatch)
    grads_j = jax.device_get(new_state.opt_state)

    port = DAIN()
    load_jax_variables(port, variables)
    opt = make_optimizer(port, TrainConfig())
    before = {k: v.clone() for k, v in port.state_dict().items()}
    kernels.reset_launches()
    metrics = train_step(port, opt, {k: nchw(v) for k, v in batch.items()},
                         TrainConfig())
    launches = dict(kernels.LAUNCHES)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    moved = {k: not torch.equal(before[k], v)
             for k, v in port.state_dict().items()}
    return (jax.device_get(metrics_j), grads_j), (metrics, grads, moved,
                                                  launches)


def test_dain_train_step_loss_matches_jax(train_step_pair):
    (metrics_j, _), (metrics, _, _, launches) = train_step_pair
    for key in ("total", "tv", "sym", "psnr"):
        np.testing.assert_allclose(float(metrics[key]), float(metrics_j[key]),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(metrics["pixel"].numpy(),
                               np.asarray(metrics_j["pixel"]), rtol=1e-4)
    assert all(n == 0 for n in launches.values()), launches


def test_dain_train_step_grads_match_jax(train_step_pair):
    """Per-leaf gradients, mapped to the JAX tree by the weight converter
    (renames and transposes apply to gradients as to weights)."""
    (_, grads_j), (_, grads, _, _) = train_step_pair
    sd = dict(grads)
    sd.update({"flownets.deconv2.weight": np.zeros((2, 2, 4, 4), np.float32),
               "flownets.deconv2.bias": np.zeros((2,), np.float32)})
    gflat = flatten_tree(convert_dain_state_dict(sd)["params"])
    jflat = flatten_tree(grads_j)
    compared = 0
    for path, jg in jflat.items():
        tg = np.asarray(gflat[path], np.float32)
        jg = np.asarray(jg, np.float32)
        assert tg.shape == jg.shape, path
        scale = max(np.abs(tg).max(), np.abs(jg).max(), 1e-12)
        np.testing.assert_allclose(tg, jg, rtol=5e-3, atol=5e-3 * scale,
                                   err_msg=str(path))
        compared += 1
    assert compared == len(grads) == 168


def test_dain_train_step_moves_every_group(train_step_pair):
    """Every parameter whose gradient is not negligible against Adamax's eps
    (1e-8) moves.  (PWC-Net's coarsest level gets ~1e-17 here.)"""
    _, (_, grads, moved, _) = train_step_pair
    for prefix in ("initScaleNets_filter", "flownets", "rectifyNet"):
        keys = [k for k in moved if k.startswith(prefix)
                and np.abs(grads[k]).max() > 1e-6]
        assert keys and all(moved[k] for k in keys), prefix


# ---------------------------------------------------------------------------
# checkpoints, resume and the trainer
# ---------------------------------------------------------------------------

def test_filtered_partial_load_skips_foreign_keys():
    model = DAIN()
    sd = {k: torch.full_like(v, 0.5) for k, v in model.state_dict().items()}
    sd["flownets.deconv2.weight"] = torch.zeros(2, 2, 4, 4)
    sd["initOcclusion.conv.weight"] = torch.zeros(3)
    loaded, skipped = filtered_partial_load(model, sd)
    assert len(loaded) == 168
    assert skipped == ["flownets.deconv2.weight", "initOcclusion.conv.weight"]
    assert all(bool((v == 0.5).all()) for v in model.state_dict().values())
    sd["rectifyNet.block5.0.bias"] = torch.zeros(4)
    with pytest.raises(ValueError, match="shape mismatch"):
        filtered_partial_load(model, sd)


def _run_trainer(dataset, save, epochs, *extra):
    train_app.main(["--device", "cpu", "--dataset-path", str(dataset),
                    "--save-path", str(save), "--batch-size", "2",
                    "--num-epochs", str(epochs), "--seed", "3", *extra])


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """An uninterrupted 2-epoch run, and 1 epoch followed by a resume to 2,
    on a synthetic dataset at 64x64 (4 train and 2 test triplets: 2 steps
    and 1 validation batch an epoch)."""
    root = tmp_path_factory.mktemp("trainer")
    data = root / "vimeo"
    subprocess.run([sys.executable, "tools/make_synthetic_vimeo.py",
                    "--out", str(data), "--n", "6", "--height", "64",
                    "--width", "64", "--test-frac", "0.34"],
                   cwd=REPO, check=True, capture_output=True, timeout=120)
    _run_trainer(data, root / "straight", 2)
    _run_trainer(data, root / "resumed", 1)
    first = {"files": sorted(os.listdir(root / "resumed")),
             "log": np.loadtxt(root / "resumed" / "log.txt", delimiter=",",
                               ndmin=2)}
    _run_trainer(data, root / "resumed", 2, "--resume")
    return root, first


def test_trainer_writes_log_and_checkpoints(trainer_runs):
    root, first = trainer_runs
    assert {"log.txt", "epoch0.pth", "best.pth", "args.txt"} <= set(
        first["files"])
    log = first["log"]
    assert log.shape == (1, 5) and log[0, 0] == 0 and log[0, 1] == 1.0
    assert np.all(np.isfinite(log))
    ck = CheckpointManager(str(root / "resumed"))
    assert ck.latest_epoch() == 1
    assert not os.path.exists(ck.path("epoch0"))     # the previous epoch


def test_resume_matches_uninterrupted_run(trainer_runs):
    root, _ = trainer_runs
    a = CheckpointManager(str(root / "straight")).load("epoch1")
    b = CheckpointManager(str(root / "resumed")).load("epoch1")
    assert a["epoch"] == b["epoch"] == 1
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)
    assert a["plateau"] == b["plateau"]
    assert a["best_val"] == b["best_val"]
    np.testing.assert_array_equal(
        np.loadtxt(root / "straight" / "log.txt", delimiter=","),
        np.loadtxt(root / "resumed" / "log.txt", delimiter=","))
