"""Carry the JAX package's weights into the port.

The port's parameter names are the reference checkpoint's keys, so the JAX
package's inverse converter (``vfidkr_tpu.convert.invert_dain_state_dict``),
which writes the reference layout, maps a flax variable tree straight onto
``model.state_dict()``.  That converter imports numpy alone, so importing it
here pulls in no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# The reference PWC-Net's deconv2, which nothing calls: the port and the JAX
# tree leave it out, but the converter's key map reads it.
_PWC_DECONV2 = {"flownets.deconv2.weight": (2, 2, 4, 4),
                "flownets.deconv2.bias": (2,)}


def load_jax_variables(model: nn.Module, variables: dict) -> list[str]:
    """Load the flax ``variables`` tree (numpy arrays, e.g. from
    ``jax.device_get(DAIN().init(...))``) into ``model`` and return the
    loaded keys.  Raises if any of the model's keys has no counterpart."""
    from vfidkr_tpu.convert import invert_dain_state_dict

    template = {k: v.detach().cpu().numpy()
                for k, v in model.state_dict().items()}
    if any(k.startswith("flownets.") for k in template):
        template.update({k: np.zeros(s, np.float32)
                         for k, s in _PWC_DECONV2.items()})
    sd, missing = invert_dain_state_dict(variables, template)
    missing = [k for k in missing if k not in _PWC_DECONV2]
    if missing:
        raise KeyError(f"no counterpart in the JAX variables for {missing}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if k not in _PWC_DECONV2})
    return sorted(k for k in sd if k not in _PWC_DECONV2)
