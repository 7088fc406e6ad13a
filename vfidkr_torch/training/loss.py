"""Losses, NCHW: counterpart of ``vfidkr_tpu/training/loss.py`` (reference
``loss_function.py:16-88``).

As in the reference, ``part_loss`` computes the pixel, offset-TV and
symmetry terms, but only the pixel losses reach the optimizer
(``train.py:186``: ``total_loss = sum(alpha_i * pixel_i)``); TV and symmetry
are logged only.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def charbonnier_loss(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """mean(sqrt(x^2 + eps^2))."""
    return torch.mean(torch.sqrt(x * x + epsilon * epsilon))


def neg_psnr_loss(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Per-sample Charbonnier, then mean of -log(1 / per) / 100."""
    per = torch.mean(torch.sqrt(x * x + epsilon * epsilon), dim=(1, 2, 3))
    return torch.mean(-torch.log(1.0 / per) / 100.0)


def tv_loss(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Total variation of (N,C,H,W) ``x``."""
    d1 = x[:, :, :-1, :-1] - x[:, :, 1:, :-1]
    d2 = x[:, :, :-1, :-1] - x[:, :, :-1, 1:]
    return torch.mean(torch.sqrt(d1 ** 2 + d2 ** 2 + epsilon * epsilon))


def gra_adap_tv_loss(flow: torch.Tensor, image: torch.Tensor,
                     epsilon: float) -> torch.Tensor:
    """TV of the projected flow weighted by exp(-|image gradient|)."""
    iw = torch.exp(-torch.sum(
        torch.abs(image[:, :, :-1, :-1] - image[:, :, 1:, :-1])
        + torch.abs(image[:, :, :-1, :-1] - image[:, :, :-1, 1:]), dim=1))
    d1 = flow[:, :, :-1, :-1] - flow[:, :, 1:, :-1]
    d2 = flow[:, :, :-1, :-1] - flow[:, :, :-1, 1:]
    tv = torch.sum(torch.sqrt(d1 ** 2 + d2 ** 2 + epsilon * epsilon), dim=1)
    return torch.mean(iw * tv)


def motion_sym_loss(offsets: Sequence[torch.Tensor],
                    epsilon: float) -> torch.Tensor:
    """Penalise F_t->0 + F_t->1 != 0."""
    return torch.mean(torch.sqrt((offsets[0] + offsets[1]) ** 2
                                 + epsilon ** 2))


def part_loss(diffs: Sequence[torch.Tensor], offsets: Sequence[torch.Tensor],
              images: Sequence[torch.Tensor], epsilon: float,
              use_neg_psnr: bool = False):
    """diffs: list of (out - gt); offsets: [off0, off1]; images: [I0, I1].
    Returns ([pixel per diff], [offset TV], [symmetry])."""
    pixel_fn = neg_psnr_loss if use_neg_psnr else charbonnier_loss
    pixel = [pixel_fn(d, epsilon) for d in diffs]
    offset = [gra_adap_tv_loss(offsets[0], images[0], epsilon)
              + gra_adap_tv_loss(offsets[1], images[1], epsilon)]
    sym = [motion_sym_loss(offsets, epsilon)]
    return pixel, offset, sym


def total_loss(pixel_losses: Sequence[torch.Tensor],
               alpha: Sequence[float]) -> torch.Tensor:
    """sum(alpha_i * pixel_i) over alpha_i > 0."""
    return sum(a * p for a, p in zip(alpha, pixel_losses) if a > 0)


def psnr_from_diff(diff: torch.Tensor) -> torch.Tensor:
    """Validation PSNR (``train.py:250-253``): per-sample MSE -> mean PSNR."""
    per_sample = torch.mean(diff ** 2, dim=(1, 2, 3))
    return (torch.mean(20.0 * torch.log(1.0 / torch.sqrt(per_sample)))
            / math.log(10.0))
