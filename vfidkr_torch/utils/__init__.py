"""Evaluation helpers, NCHW: replication padding, the metrics, the
running mean, and the program's profiler spans and trace.  The frame files
(``image_io``) and the depth metrics (``depth_eval``) are submodules."""

from vfidkr_torch.utils.meters import AverageMeter, RunningMean
from vfidkr_torch.utils.metrics import (interpolation_error, psnr,
                                        psnr_per_image, ssim, ssim_per_image)
from vfidkr_torch.utils.padding import pad_to_multiple, unpad
from vfidkr_torch.utils.profiling import span, trace

__all__ = ["interpolation_error", "psnr", "psnr_per_image", "ssim",
           "ssim_per_image", "AverageMeter", "RunningMean",
           "pad_to_multiple", "unpad", "span", "trace"]
