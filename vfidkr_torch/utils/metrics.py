"""Evaluation metrics with the reference eval scripts' formulas, NCHW.

Counterpart of ``vfidkr_tpu/utils/metrics.py:21-104``:

* IE (interpolation error): mean |diff| on [0, 255] images
  (``demo_MiddleBury.py:367``);
* PSNR from the MSE on [0, 255] images (``:368-371``); batched inputs
  average the per-image PSNRs, as the reference averages over its set;
* SSIM: separable 11-tap Gaussian (sigma 1.5), VALID windows, K = (0.01,
  0.03), data range 1 (``:24-162``).

SSIM's Gaussian is weighted sums of shifted slices in float32, so it runs
at full float32 precision on any device (the JAX code asks for HIGHEST
precision; a cuDNN depthwise conv would run in TF32 by default, and the
sigma terms, differences of E[x^2] and mu^2, cancel).
"""

from __future__ import annotations

import numpy as np
import torch


def interpolation_error(pred_255: torch.Tensor,
                        gt_255: torch.Tensor) -> torch.Tensor:
    """Mean |diff| on [0, 255] images (any shape)."""
    return (pred_255.float() - gt_255.float()).abs().mean()


def psnr_per_image(pred_255: torch.Tensor,
                   gt_255: torch.Tensor) -> torch.Tensor:
    """(B,) PSNRs: 20 log10(255 / sqrt(MSE)) of each image."""
    diff = pred_255.float() - gt_255.float()
    mse = (diff * diff).mean(dim=(1, 2, 3))
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def psnr(pred_255: torch.Tensor, gt_255: torch.Tensor) -> torch.Tensor:
    """The mean of the per-image PSNRs of a (B,C,H,W) batch; a (C,H,W)
    input is one image."""
    if pred_255.dim() == 3:
        return psnr_per_image(pred_255[None], gt_255[None])[0]
    return psnr_per_image(pred_255, gt_255).mean()


def _gauss_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _gaussian_filter(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable VALID Gaussian blur along H, then W, of (B,C,H,W)."""
    k = len(win)
    h, w = x.shape[2] - k + 1, x.shape[3] - k + 1
    x = sum(float(win[i]) * x[:, :, i:i + h] for i in range(k))
    return sum(float(win[i]) * x[:, :, :, i:i + w] for i in range(k))


def ssim_per_image(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
                   win_size: int = 11, win_sigma: float = 1.5,
                   k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """(B,C,H,W) float images -> (B,) SSIMs (the reference formula, reduced
    over C, H and W only)."""
    win = _gauss_1d(win_size, win_sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x, y = x.float(), y.float()
    mu1, mu2 = _gaussian_filter(x, win), _gaussian_filter(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = _gaussian_filter(y * y, win) - mu2_sq
    sigma12 = _gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3))


def ssim(x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
    """(B,C,H,W) float images -> the mean SSIM."""
    return ssim_per_image(x, y, **kw).mean()
