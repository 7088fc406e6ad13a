"""The ops of DAIN and DAIN_slowmotion, NCHW (see
``vfidkr_torch/__init__.py``)."""

from vfidkr_torch.ops.correlation import correlation_cost_volume
from vfidkr_torch.ops.filter_interpolation import filter_interpolate
from vfidkr_torch.ops.flow_projection import (depth_flow_project, fill_holes,
                                             flow_project)
from vfidkr_torch.ops.warp import pwc_warp

__all__ = ["correlation_cost_volume", "depth_flow_project", "fill_holes",
           "filter_interpolate", "flow_project", "pwc_warp"]
