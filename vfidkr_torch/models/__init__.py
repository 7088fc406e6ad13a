"""DAIN eval networks, NCHW (see ``vfidkr_torch/__init__.py``)."""

from vfidkr_torch.models.dain import DAIN
from vfidkr_torch.models.mononet import BranchHead, MonoNet5
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.models.resblock import MultipleBasicBlock, ResBasicBlock

__all__ = ["DAIN", "BranchHead", "MonoNet5", "MultipleBasicBlock",
           "PWCDCNet", "ResBasicBlock"]
