"""DAIN training, NCHW (see ``vfidkr_torch/__init__.py``)."""

from vfidkr_torch.training.checkpoint import (CheckpointManager,
                                              filtered_partial_load,
                                              full_state, restore_full_state)
from vfidkr_torch.training.loss import (charbonnier_loss, gra_adap_tv_loss,
                                        motion_sym_loss, neg_psnr_loss,
                                        part_loss, psnr_from_diff,
                                        total_loss, tv_loss)
from vfidkr_torch.training.lr_schedule import (PlateauState, plateau_init,
                                               plateau_step)
from vfidkr_torch.training.train_state import (TrainConfig, eval_step,
                                               make_optimizer, train_step)

__all__ = [
    "CheckpointManager", "filtered_partial_load", "full_state",
    "restore_full_state", "charbonnier_loss", "gra_adap_tv_loss",
    "motion_sym_loss", "neg_psnr_loss", "part_loss", "psnr_from_diff",
    "total_loss", "tv_loss", "PlateauState", "plateau_init", "plateau_step",
    "TrainConfig", "eval_step", "make_optimizer", "train_step",
]
