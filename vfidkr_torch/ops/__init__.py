"""The ops of DAIN and DAIN_slowmotion, and the reference's dormant ones,
NCHW (see ``vfidkr_torch/__init__.py``); the exports of the JAX package's
``vfidkr_tpu/ops/__init__.py``."""

from vfidkr_torch.ops.correlation import correlation_cost_volume
from vfidkr_torch.ops.filter_interpolation import (
    filter_interpolate, filter_interpolate_deformable,
    filter_interpolate_nofilter_deformable)
from vfidkr_torch.ops.flow_projection import (depth_flow_project, fill_holes,
                                             flow_project,
                                             min_depth_flow_project)
from vfidkr_torch.ops.separable_conv import (separable_conv,
                                             separable_conv_flow)
from vfidkr_torch.ops.warp import interpolate_bilinear, pwc_warp

__all__ = ["correlation_cost_volume", "depth_flow_project", "fill_holes",
           "filter_interpolate", "filter_interpolate_deformable",
           "filter_interpolate_nofilter_deformable", "flow_project",
           "interpolate_bilinear", "min_depth_flow_project", "pwc_warp",
           "separable_conv", "separable_conv_flow"]
