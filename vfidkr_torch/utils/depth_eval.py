"""MegaDepth depth-evaluation metrics on tensors: the scale-invariant RMSE
and the depth-ordinal (SDR) error counts.  Counterpart of
``vfidkr_tpu/utils/depth_eval.py:18,34`` (reference
``MegaDepth/models/HG_model.py:50-166``, driven by ``rmse_error_main.py``
and ``SDR_compute.py``).  The interpolation networks never call them; they
evaluate the MegaDepth hourglass as a depth estimator.
"""

from __future__ import annotations

import torch


def scale_invariant_rmse(log_pred: torch.Tensor, log_gt: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """``HG_model.rmse_Loss`` (:133-144): ``sqrt(mean(d^2) - mean(d)^2)``
    over the masked pixels, ``d = (log_pred - log_gt) * mask``; (H, W) or
    broadcastable tensors, mask in {0, 1}.  Returns a scalar."""
    n = mask.sum()
    d = (log_pred - log_gt) * mask
    return torch.sqrt((d * d).sum() / n - d.sum().square() / (n * n))


def sdr_counts(log_pred: torch.Tensor, x_a, y_a, x_b, y_b, gt_ordinal,
               threshold: float = 1.1):
    """``HG_model.batch_classify`` / ``computeSDR`` (:50-124): the
    predicted ordinal relation of each point pair (+1 where z_A / z_B >
    ``threshold``, -1 below its inverse, else 0) against ``gt_ordinal``.

    ``log_pred`` is (H, W); the coordinates and labels (P,) integer
    tensors on its device.  Returns (errors, counts), each an int64
    3-vector [equal, unequal, total], the reference's ``error_list`` and
    ``count_list``."""
    depth = torch.exp(log_pred)
    ratio = depth[y_a, x_a] / depth[y_b, x_b]
    est = torch.where(ratio > threshold, 1,
                      torch.where(ratio < 1.0 / threshold, -1, 0))
    diff = (est != gt_ordinal).long()
    unequal = gt_ordinal != 0
    unequal_err = diff[unequal].sum()
    total_err = diff.sum()
    unequal_n = unequal.long().sum()
    total = torch.tensor(gt_ordinal.shape[0], device=log_pred.device)
    return (torch.stack([total_err - unequal_err, unequal_err, total_err]),
            torch.stack([total - unequal_n, unequal_n, total]))
