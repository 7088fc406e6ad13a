"""The plain training step of DAIN: the loss, its gradients and Adamax.

As the VFIDKR repository's ``train.py`` trains (``my_args.py`` defaults):
the loss is the Charbonnier loss (epsilon 1e-6) of the rectified output
against the middle frame (``alpha = (0, 1)``: the blend's loss has weight
0); the flow projection leaves holes at 0 in training; Adamax (betas 0.9,
0.999, eps 1e-8, as ``torch.optim.Adamax`` states it) in three groups: the
kernel nets at lr 2e-3, PWC-Net at 2e-3 x 0.01, the rectifier at 1e-3.
The vestigial children train in no group.
"""

from __future__ import annotations

import torch

from benchmark.reference import nets

GROUPS = {"filter": (("initScaleNets_filter.", "initScaleNets_filter1.",
                      "initScaleNets_filter2."), 2e-3),
          "flow": (("flownets.",), 2e-3 * 0.01),
          "rectify": (("rectifyNet.",), 1e-3)}
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
CHARBONNIER_EPS = 1e-6


def trained(P: dict) -> dict:
    """name -> learning rate of every trained parameter."""
    out = {}
    for prefixes, lr in GROUPS.values():
        for k in P:
            if k.startswith(prefixes) and not k.endswith(
                    ("running_mean", "running_var", "num_batches_tracked")):
                out[k] = lr
    return out


def loss_and_grads(P: dict, batch: dict, lane: dict, leaves) -> tuple:
    """(loss, {leaf: gradient}) of one batch (x0, x1, y)."""
    params = {k: P[k].detach().clone().requires_grad_() for k in leaves}
    full = dict(P, **params)
    out = nets.dain(full, batch["x0"], batch["x1"], lane, training=True)
    diff = out["outputs"][1] - batch["y"]
    loss = torch.mean(torch.sqrt(diff * diff + CHARBONNIER_EPS ** 2))
    grads = torch.autograd.grad(loss, [params[k] for k in leaves])
    return float(loss.detach()), dict(zip(leaves, grads))


class Adamax:
    """``torch.optim.Adamax``'s update, one tensor at a time."""

    def __init__(self, lrs: dict):
        self.lrs, self.t = lrs, 0
        self.m, self.u = {}, {}

    def step(self, P: dict, grads: dict) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            u = self.u.get(k, torch.zeros_like(g))
            m = m + (1 - BETA1) * (g - m)
            u = torch.maximum(u * BETA2, g.abs() + EPS)
            self.m[k], self.u[k] = m, u
            P[k] = P[k] - (self.lrs[k] / (1 - BETA1 ** self.t)) * m / u


def train_steps(P: dict, batches: list, lane: dict) -> dict:
    """The reference's steps over ``batches`` from the weights ``P`` (not
    changed): {"losses", "grad1" (the first step's gradients), "change"
    (each trained leaf's change over the steps)}."""
    lrs = trained(P)
    leaves = list(lrs)
    state = dict(P)
    opt = Adamax(lrs)
    losses, grad1 = [], None
    for batch in batches:
        loss, grads = loss_and_grads(state, batch, lane, leaves)
        losses.append(loss)
        if grad1 is None:
            grad1 = grads
        opt.step(state, grads)
    return {"losses": losses, "grad1": grad1,
            "change": {k: state[k] - P[k] for k in leaves}}
