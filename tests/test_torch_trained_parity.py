"""The port's trainer held to the JAX package's over several steps: DAIN at
64x64, B=1, from JAX's initial weights, three Adamax steps on the batches
of both loaders (the port's through its C++ augment; checked bit for bit
at every step by tools/trained_parity_torch.py's ``train_pair``, which
tools/trained_parity_torch.py runs at 128x256 for 100 steps with the
plateau schedule and the eval-protocol PSNR).

Tolerances.  The first step's loss within rtol 1e-4, as
tests/test_torch_train.py holds one step's, and at every step the port's
forward on JAX's weights of that step within the same rtol 1e-4.  The
port's own losses after the first step within rtol 1e-3, widened for a
measured reason: Adamax's first step moves each parameter by lr times the
sign of its gradient, and 1940 of DAIN's 16.06 M elements, each with a
gradient under 1.91e-5 of its leaf's largest (rounding noise), took the
opposite sign in the two packages; on the next batch the port's own weights
gave 303.604156 and JAX's weights in the port gave JAX's 303.666504, a
relative gap of 2.05e-4 that comes from the weights alone.  So the weights
are not compared element by element either.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfidkr_torch.data import synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trained_parity_torch",
        os.path.join(REPO, "tools", "trained_parity_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vimeo"))
    synthetic.main(["--out", root, "--n", "6", "--height", "64", "--width",
                    "64", "--test-frac", "0.2"])
    return _tool().train_pair("DAIN", root, STEPS, STEPS, validate=False,
                              twin=True)


def test_every_step_loss_matches_jax(run):
    assert run["steps"] == len(run["loss_jax"]) == len(run["loss_port"]) \
        == STEPS
    assert all(np.isfinite(run["loss_port"]))
    np.testing.assert_allclose(run["loss_port"][0], run["loss_jax"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(run["loss_port"], run["loss_jax"], rtol=1e-3)


def test_every_step_forward_on_jax_weights_matches_jax(run):
    """The port's forward, given JAX's weights at each step, gives JAX's
    loss: the gap above is the optimizers' sign flips, not the forward."""
    np.testing.assert_allclose(run["loss_port_on_jax_weights"],
                               run["loss_jax"], rtol=1e-4)


def test_the_steps_train(run):
    """The steps move the model: the losses are not one value repeated, and
    neither package's plateau scale moved without a validation."""
    assert len(set(run["loss_port"])) == STEPS
    assert run["lr_scale_jax"] == run["lr_scale_port"] == [1.0] * STEPS
