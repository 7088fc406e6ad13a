"""Evaluation helpers, NCHW: replication padding and the metrics."""

from vfidkr_torch.utils.metrics import (interpolation_error, psnr,
                                        psnr_per_image, ssim, ssim_per_image)
from vfidkr_torch.utils.padding import pad_to_multiple, unpad

__all__ = ["interpolation_error", "psnr", "psnr_per_image", "ssim",
           "ssim_per_image", "pad_to_multiple", "unpad"]
