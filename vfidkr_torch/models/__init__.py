"""DAIN, DAIN_slowmotion, SepConv, SoftSplat and AdaCoF+ networks, NCHW
(see ``vfidkr_torch/__init__.py``), and the name-keyed model lookup of
``vfidkr_tpu/models/__init__.py`` (reference ``networks/__init__.py``),
which adds SepConv, SoftSplat and AdaCoF+ to the JAX package's two."""

from vfidkr_torch.models.adacof import AdaCoFPlus
from vfidkr_torch.models.dain import DAIN, DAINSlowMotion
from vfidkr_torch.models.megadepth import MegaDepthHourglass
from vfidkr_torch.models.mononet import BranchHead, MonoNet5
from vfidkr_torch.models.pwcnet import PWCDCNet
from vfidkr_torch.models.resblock import (MultipleBasicBlock, ResBasicBlock,
                                          multiple_basic_block_4)
from vfidkr_torch.models.s2df import S2DF, s2df_3dense
from vfidkr_torch.models.sepconv import SepConv
from vfidkr_torch.models.softsplat import SoftSplat

MODEL_REGISTRY = {
    "DAIN": DAIN,
    "DAIN_slowmotion": DAINSlowMotion,
    "SepConv": SepConv,
    "SoftSplat": SoftSplat,
    "AdaCoFPlus": AdaCoFPlus,
}


def build_model(name: str, **kwargs):
    """The model registered as ``name``, built with ``kwargs`` (the
    reference's ``networks.__dict__[name](...)``, ``train.py:29-32``)."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"net_name must be one of {tuple(MODEL_REGISTRY)}, "
                         f"got {name!r}")
    return MODEL_REGISTRY[name](**kwargs)


__all__ = ["AdaCoFPlus", "DAIN", "DAINSlowMotion", "BranchHead", "MegaDepthHourglass",
           "MonoNet5", "MultipleBasicBlock", "PWCDCNet", "ResBasicBlock",
           "S2DF", "SepConv", "SoftSplat", "multiple_basic_block_4", "s2df_3dense",
           "MODEL_REGISTRY",
           "build_model"]
