"""DAIN and DAIN_slowmotion networks, NCHW (see
``vfidkr_torch/__init__.py``)."""

from vfidkr_torch.models.dain import DAIN, DAINSlowMotion
from vfidkr_torch.models.megadepth import MegaDepthHourglass
from vfidkr_torch.models.mononet import BranchHead, MonoNet5
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.models.resblock import MultipleBasicBlock, ResBasicBlock
from vfidkr_torch.models.s2df import S2DF

__all__ = ["DAIN", "DAINSlowMotion", "BranchHead", "MegaDepthHourglass",
           "MonoNet5", "MultipleBasicBlock", "PWCDCNet", "ResBasicBlock",
           "S2DF"]
