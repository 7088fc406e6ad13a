"""The plain training step: the loss, its gradients and Adamax.

As the VFIDKR repository's ``train.py`` trains (``my_args.py`` defaults),
through whichever reference a configuration names
(``benchmark.lib.cell.Reference``): the reference's forward in training
gives two lists of frames, the blends and the rectified frames, one frame
a synthesised frame; each list's pixel loss is the mean over its frames of
their Charbonnier losses (epsilon 1e-6) against the middle frame, and the
loss is ``alpha``'s sum of them, ``alpha = (0, 1)`` (the blends' loss has
weight 0).  At t = 0.5 there is one frame a list.  Adamax (betas 0.9,
0.999, eps 1e-8, as ``torch.optim.Adamax`` states it) over the reference's
trained groups (its file's ``GROUPS``: name prefixes and learning rates).
A new configuration brings its own reference file, with its groups, and
needs no edit here.
"""

from __future__ import annotations

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
CHARBONNIER_EPS = 1e-6
ALPHA = (0.0, 1.0)          # the blends' and the rectified frames' weights


def trained(P: dict, groups: dict) -> dict:
    """name -> learning rate of every parameter of ``groups`` ({group:
    (name prefixes, learning rate)})."""
    out = {}
    for prefixes, lr in groups.values():
        for k in P:
            if k.startswith(prefixes) and not k.endswith(
                    ("running_mean", "running_var", "num_batches_tracked")):
                out[k] = lr
    return out


def charbonnier(diff: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sqrt(diff * diff + CHARBONNIER_EPS ** 2))


def loss_and_grads(reference, config: dict, P: dict, batch: dict,
                   lane: dict, leaves) -> tuple:
    """(loss, {leaf: gradient}) of one batch (x0, x1, y) through
    ``reference`` in training."""
    params = {k: P[k].detach().clone().requires_grad_() for k in leaves}
    full = dict(P, **params)
    lists = reference.forward(full, batch["x0"], batch["x1"], lane, config,
                              training=True)
    loss = sum(a * sum(charbonnier(o - batch["y"]) for o in frames)
               / len(frames) for a, frames in zip(ALPHA, lists) if a > 0)
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


def train_steps(reference, config: dict, P: dict, batches: list,
                lane: dict) -> dict:
    """The reference's steps over ``batches`` from the weights ``P`` (not
    changed): {"losses", "grad1" (the first step's gradients), "change"
    (each trained leaf's change over the steps)}."""
    lrs = trained(P, reference.groups)
    leaves = list(lrs)
    state = dict(P)
    opt = Adamax(lrs)
    losses, grad1 = [], None
    for batch in batches:
        loss, grads = loss_and_grads(reference, config, state, batch, lane,
                                     leaves)
        losses.append(loss)
        if grad1 is None:
            grad1 = grads
        opt.step(state, grads)
    return {"losses": losses, "grad1": grad1,
            "change": {k: state[k] - P[k] for k in leaves}}
