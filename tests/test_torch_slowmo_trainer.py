"""DAIN_slowmotion training in the port: the train mode, the frozen nets,
the gradient structure of the whole graph, and the trainer.

JAX's slow-motion trainer keeps MegaDepth's BN on running statistics
(``train_bn=False``, ``vfidkr_tpu/models/dain.py:185``) and freezes the
context and depth nets (``vfidkr_tpu/training/train_state.py:48-56``); with
nothing frozen its graph carries gradient to both
(``tests/test_slowmotion_backward.py``).  The port does the same on the CPU
here, at 64x64, B=1.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfidkr_torch import kernels  # noqa: E402
from vfidkr_torch.apps import train as train_app  # noqa: E402
from vfidkr_torch.models import DAINSlowMotion  # noqa: E402
from vfidkr_torch.training import (CheckpointManager, TrainConfig,  # noqa: E402
                                   make_optimizer, restore_full_state)
from vfidkr_torch.training.train_state import FROZEN, GROUPS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64


def _frames(seed, n=3):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(1, 3, H, W).astype(np.float32))
            for _ in range(n)]


def test_train_mode_keeps_megadepth_on_running_statistics():
    """``train()`` switches every child but MegaDepth, whose BN buffers a
    train-mode forward leaves as they were; ``eval()`` switches back."""
    model = DAINSlowMotion(0.5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, buf in model.depthNet.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.1, 0.1)
    assert model.train() is model
    assert model.training and model.ctxNet.training
    assert model.rectifyNet.training and model.flownets.training
    assert not any(m.training for m in model.depthNet.modules())
    before = {k: v.clone() for k, v in model.depthNet.state_dict().items()}
    i0, i2, _ = _frames(0)
    with torch.no_grad():
        model(i0, i2)
    for k, v in model.depthNet.state_dict().items():
        assert torch.equal(v, before[k]), k
    model.eval()
    assert not model.training and not model.ctxNet.training


def test_train_mode_skips_the_hole_fill():
    """In training the projection leaves holes at 0 (no K3), in eval it
    fills them, as JAX's ``hole_fill = not train``."""
    model = DAINSlowMotion(0.5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.flownets.dc_conv7.bias.add_(torch.tensor([1.5, -0.9]))
    i0, i2, _ = _frames(1)
    with torch.no_grad():
        train_offs = torch.cat(model.train()(i0, i2)["offsets"])
        eval_offs = torch.cat(model.eval()(i0, i2)["offsets"])
    holes = (train_offs == 0).all(1)
    assert holes.any() and not (eval_offs == 0).all(1).all()
    filled = ~holes.unsqueeze(1).expand_as(train_offs)
    torch.testing.assert_close(train_offs[filled], eval_offs[filled])


def test_make_optimizer_freezes_context_and_depth_nets():
    model = DAINSlowMotion(0.5)
    opt = make_optimizer(model, TrainConfig())
    assert [g["name"] for g in opt.param_groups] == list(GROUPS)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name.startswith(FROZEN)
        assert (id(p) in in_groups) != frozen, name
        assert p.requires_grad != frozen, name


def test_unfrozen_graph_gives_every_net_a_gradient():
    """With nothing frozen, the context net takes gradient through the
    warped context features and MegaDepth through the depth weighting of the
    projection (its log-depth context channel is detached): finite and not
    zero, as JAX's test asserts."""
    model = DAINSlowMotion(0.5, generator=torch.Generator().manual_seed(0))
    model.train()
    i0, i1, i2 = _frames(2)
    kernels.reset_launches()
    res = model(i0, i2)
    outs, rects = res["outputs"]
    loss = sum(torch.mean(torch.abs(o - i1)) for o in outs + rects)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    for child in ("rectifyNet", "initScaleNets_filter", "flownets",
                  "ctxNet", "depthNet"):
        grads = [p.grad for p in getattr(model, child).parameters()]
        assert all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads), child
        assert sum(g.abs().sum().item() for g in grads) > 0, child


def _run_trainer(dataset, save, epochs, *extra):
    train_app.main(["--device", "cpu", "--net-name", "DAIN_slowmotion",
                    "--dataset-path", str(dataset), "--save-path", str(save),
                    "--batch-size", "1", "--steps-per-epoch", "2",
                    "--val-batches", "1", "--num-epochs", str(epochs),
                    "--seed", "5", *extra])


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    """One epoch of 2 steps on a synthetic 64x64 set, then a resume to a
    second epoch."""
    root = tmp_path_factory.mktemp("slowmo_trainer")
    data = root / "vimeo"
    subprocess.run([sys.executable, "tools/make_synthetic_vimeo.py",
                    "--out", str(data), "--n", "4", "--height", "64",
                    "--width", "64", "--test-frac", "0.25"],
                   cwd=REPO, check=True, capture_output=True, timeout=120)
    _run_trainer(data, root / "run", 1)
    first = CheckpointManager(str(root / "run")).load("epoch0")
    _run_trainer(data, root / "run", 2, "--resume")
    return root / "run", first


def test_slowmo_trainer_trains_and_resumes(trainer_run):
    run, first = trainer_run
    log = np.loadtxt(run / "log.txt", delimiter=",", ndmin=2)
    assert log.shape == (2, 5) and list(log[:, 0]) == [0, 1]
    assert np.all(np.isfinite(log))
    ck = CheckpointManager(str(run))
    assert ck.latest_epoch() == 1 and not os.path.exists(ck.path("epoch0"))
    last = ck.load("epoch1")
    assert last["epoch"] == 1
    moved = [k for k in first["model"]
             if not torch.equal(first["model"][k], last["model"][k])]
    assert moved and not any(k.startswith(FROZEN) for k in moved)


def test_slowmo_checkpoint_loads_back(trainer_run):
    """The trainer's checkpoint restores a fresh DAINSlowMotion(0.5) and its
    optimizer: every tensor, MegaDepth's BN buffers included."""
    run, _ = trainer_run
    state = CheckpointManager(str(run)).load("epoch1")
    model = DAINSlowMotion(0.5)
    opt = make_optimizer(model, TrainConfig())
    plateau = restore_full_state(state, model, opt)
    assert plateau.scale == state["plateau"]["scale"]
    sd = model.state_dict()
    assert sd.keys() == state["model"].keys()
    assert any(k.startswith("depthNet") and k.endswith("running_var")
               for k in sd)
    for k, v in state["model"].items():
        assert torch.equal(sd[k], v), k
    assert len(opt.state) == sum(len(g["params"]) for g in opt.param_groups)
