"""Optimizer and the train and eval steps: counterpart of
``vfidkr_tpu/training/train_state.py:28-200`` (reference ``train.py:85-260``).

The reference trains with Adamax in parameter groups: the three
kernel-prediction nets at ``filter_lr_coe * lr``, PWC-Net at
``flow_lr_coe * lr`` and the rectifier at ``rectify_lr``.  Its vestigial
OccNet, DeconvField and context nets join no optimizer; the port does not
build them, so every parameter of the port's DAIN belongs to one of the three
groups.  The plateau schedule's ``scale`` multiplies every group's rate, as
ReduceLROnPlateau reduces every group by the same factor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from vfidkr_torch.training import loss as L


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's defaults (``my_args.py:13-74``)."""
    lr: float = 2e-3
    rectify_lr: float = 1e-3
    filter_lr_coe: float = 1.0
    flow_lr_coe: float = 0.01
    alpha: Tuple[float, ...] = (0.0, 1.0)
    epsilon: float = 1e-6
    factor: float = 0.2        # ReduceLROnPlateau factor
    patience: int = 3


# optimizer group -> the DAIN children it trains
GROUPS = {
    "filter": ("initScaleNets_filter", "initScaleNets_filter1",
               "initScaleNets_filter2"),
    "flow": ("flownets",),
    "rectify": ("rectifyNet",),
}


def make_optimizer(model: nn.Module, config: TrainConfig) -> torch.optim.Adamax:
    """Adamax (betas 0.9/0.999, eps 1e-8) over the three groups; each group
    keeps its ``base_lr`` beside the ``lr`` that ``set_lr_scale`` sets."""
    lrs = {"filter": config.filter_lr_coe * config.lr,
           "flow": config.flow_lr_coe * config.lr,
           "rectify": config.rectify_lr}
    groups = []
    for name, children in GROUPS.items():
        params = [p for child in children
                  for p in getattr(model, child).parameters()]
        groups.append({"params": params, "lr": lrs[name],
                       "base_lr": lrs[name], "name": name})
    grouped = sum(len(g["params"]) for g in groups)
    total = len(list(model.parameters()))
    if grouped != total:
        raise ValueError(f"{total - grouped} parameters belong to no group")
    return torch.optim.Adamax(groups, betas=(0.9, 0.999), eps=1e-8)


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * scale


def _model_losses(model, batch, config: TrainConfig):
    """Forward and the reference's loss decomposition -> (total, metrics)."""
    res = model(batch["x0"], batch["x1"])
    diffs = [o - batch["y"] for o in res["outputs"]]
    pixel, offset, sym = L.part_loss(diffs, res["offsets"],
                                     [batch["x0"], batch["x1"]],
                                     config.epsilon)
    total = L.total_loss(pixel, config.alpha)
    metrics = {"pixel": torch.stack(pixel), "tv": offset[0], "sym": sym[0],
               "total": total, "psnr": L.psnr_from_diff(diffs[-1])}
    return total, metrics


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], config: TrainConfig,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """One optimizer step in train mode (``train.py:178-207``); ``batch``
    holds x0, x1 and the target y, (B,3,H,W) on the model's device.  The
    gradients stay in ``p.grad`` until the next step.  Returns the detached
    metrics: pixel (one per output), tv, sym, total, psnr."""
    model.train()
    set_lr_scale(optimizer, scale)
    optimizer.zero_grad(set_to_none=True)
    total, metrics = _model_losses(model, batch, config)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor],
              config: TrainConfig) -> Dict[str, torch.Tensor]:
    """Validation (``train.py:233-260``): eval mode under ``no_grad``, so
    the projection fills holes, as the reference's does under no_grad."""
    model.eval()
    with torch.no_grad():
        _, metrics = _model_losses(model, batch, config)
    return metrics
