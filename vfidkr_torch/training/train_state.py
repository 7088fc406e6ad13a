"""Optimizer and the train and eval steps: counterpart of
``vfidkr_tpu/training/train_state.py:28-200`` (reference ``train.py:85-260``).

The reference trains with Adamax in parameter groups: the three
kernel-prediction nets at ``filter_lr_coe * lr``, PWC-Net at
``flow_lr_coe * lr`` and the rectifier at ``rectify_lr``.  DAIN's vestigial
OccNet, DeconvField and context net join no optimizer, nor do
DAIN_slowmotion's context and depth nets: they are ``FROZEN``, JAX's
``stop_gradient`` plus ``set_to_zero``
(``vfidkr_tpu/training/train_state.py:48-56,78,170-175``).  Every other
parameter belongs to one of the three groups.  The plateau schedule's
``scale`` multiplies every group's rate, as ReduceLROnPlateau reduces every
group by the same factor.

``train_step``'s phases run in the profiler spans ``vfidkr/train/zero_grad``,
``vfidkr/train/loss`` (the loss terms, whose backward is
``vfidkr/train/loss/backward``), ``vfidkr/train/backward`` and
``vfidkr/train/optimizer`` (``utils.profiling.span``); the model's forward
has its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from vfidkr_torch.training import loss as L
from vfidkr_torch.utils.profiling import span


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
# children that no optimizer trains and autograd skips: DAIN_slowmotion's
# context and depth nets, and DAIN's vestigial ones (models.dain.VESTIGIAL)
FROZEN = ("ctxNet", "depthNet", "initOcclusion", "initDeconv_field")


def make_optimizer(model: nn.Module, config: TrainConfig) -> torch.optim.Adamax:
    """Adamax (betas 0.9/0.999, eps 1e-8) over the three groups; each group
    keeps its ``base_lr`` beside the ``lr`` that ``set_lr_scale`` sets.
    The ``FROZEN`` children's parameters get ``requires_grad_(False)``, so
    autograd records nothing through them, and join no group."""
    lrs = {"filter": config.filter_lr_coe * config.lr,
           "flow": config.flow_lr_coe * config.lr,
           "rectify": config.rectify_lr}
    groups = []
    for name, children in GROUPS.items():
        params = [p for child in children
                  for p in getattr(model, child).parameters()]
        groups.append({"params": params, "lr": lrs[name],
                       "base_lr": lrs[name], "name": name})
    frozen = [p for child in FROZEN if hasattr(model, child)
              for p in getattr(model, child).parameters()]
    for p in frozen:
        p.requires_grad_(False)
    grouped = sum(len(g["params"]) for g in groups)
    total = len(list(model.parameters()))
    if grouped + len(frozen) != total:
        raise ValueError(f"{total - grouped - len(frozen)} parameters "
                         f"belong to no group")
    return torch.optim.Adamax(groups, betas=(0.9, 0.999), eps=1e-8)


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * scale


def _model_losses(model, batch, config: TrainConfig):
    """Forward and the reference's loss decomposition -> (total, metrics).

    DAIN_slowmotion's outputs are lists, one frame a step: each pixel loss
    is the mean over the frames of their Charbonnier losses, and the
    regularisers and the PSNR read the last frame, as JAX's
    (``vfidkr_tpu/training/train_state.py:119-133``)."""
    res = model(batch["x0"], batch["x1"])
    with span("vfidkr/train/loss") as s:
        frames = [o if isinstance(o, list) else [o] for o in res["outputs"]]
        diffs = [[o - batch["y"] for o in outs] for outs in frames]
        _, offset, sym = L.part_loss([ds[-1] for ds in diffs],
                                     res["offsets"],
                                     [batch["x0"], batch["x1"]],
                                     config.epsilon)
        pixel = [sum(L.charbonnier_loss(d, config.epsilon) for d in ds)
                 / len(ds) for ds in diffs]
        diffs = [ds[-1] for ds in diffs]
        total = L.total_loss(pixel, config.alpha)
        metrics = {"pixel": torch.stack(pixel), "tv": offset[0],
                   "sym": sym[0], "total": total,
                   "psnr": L.psnr_from_diff(diffs[-1])}
        s.outputs(total)
    return total, metrics


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], config: TrainConfig,
               scale: float = 1.0,
               reduce_grads: Optional[Callable[[nn.Module], None]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step in train mode (``train.py:178-207``); ``batch``
    holds x0, x1 and the target y, (B,3,H,W) on the model's device.
    ``reduce_grads(model)``, where given, runs between the backward and the
    optimizer step (the data-parallel mean across ranks).  The gradients
    stay in ``p.grad`` until the next step.  Returns the detached metrics:
    pixel (one per output), tv, sym, total, psnr."""
    model.train()
    with span("vfidkr/train/zero_grad"):
        set_lr_scale(optimizer, scale)
        optimizer.zero_grad(set_to_none=True)
    total, metrics = _model_losses(model, batch, config)
    with span("vfidkr/train/backward"):
        total.backward()
        if reduce_grads is not None:
            reduce_grads(model)
    with span("vfidkr/train/optimizer"):
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
