"""Replication padding of eval frames, NCHW.

Counterpart of ``vfidkr_tpu/utils/padding.py:15-41`` (reference
``demo_MiddleBury.py:294-312``, the same in ``demo_test_ourdata.py:273-291``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, multiple: int = 128, min_pad: int = 32
                    ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """(B,C,H,W) -> (padded, (left, right, top, bottom)).

    A dim not divisible by ``multiple`` is padded up to the next multiple,
    split evenly with the smaller half on the left or top; a dim that is
    divisible gets exactly ``min_pad`` on each side (256 -> 320: the result
    is only sure to divide by 64, which is what the networks need)."""
    def pads(dim):
        if dim % multiple:
            total = multiple - dim % multiple
            return total // 2, total - total // 2
        return min_pad, min_pad

    top, bottom = pads(x.shape[2])
    left, right = pads(x.shape[3])
    return (F.pad(x, (left, right, top, bottom), mode="replicate"),
            (left, right, top, bottom))


def unpad(x: torch.Tensor, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    left, right, top, bottom = pads
    return x[:, :, top:x.shape[2] - bottom, left:x.shape[3] - right]
