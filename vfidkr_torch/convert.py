"""Carry the JAX package's weights into the port.

The port's parameter names are the reference checkpoint's keys, so the
inverse of the reference-checkpoint converter maps a flax variable tree
straight onto ``model.state_dict()``.  This module keeps its own numpy copy
of both halves:

* the key map, reference state_dict -> flax tree (``convert_dain_state_dict``,
  the counterpart of ``vfidkr_tpu/convert/torch_loader.py:37-215``), for the
  networks the port builds: PWC-Net, MonoNet5 and its heads, S2DF, the
  rectifier and MegaDepth (its BN running statistics in ``batch_stats``);
* its inverse (``invert_dain_state_dict``, the counterpart of
  ``vfidkr_tpu/convert/inverse.py:30-102``), derived from the key map: the
  map runs on index arrays tagged with their reference key, so each flax
  leaf carries where every one of its elements came from, and inverting a
  leaf is a scatter.

The vestigial ``OccNet`` and ``DeconvField``, which the port does not build,
are left out of the key map.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# The reference PWC-Net's deconv2, which nothing calls: the port and the JAX
# tree leave it out, but the key map reads it.
_PWC_DECONV2 = {"flownets.deconv2.weight": (2, 2, 4, 4),
                "flownets.deconv2.bias": (2,)}
# BN counters that flax does not keep: the port's own values stay.
_NO_COUNTERPART = "num_batches_tracked"


def conv_w(t: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(t, (2, 3, 1, 0))


def deconv_w(t: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I,O,kh,kw) -> HWIO with I in third position."""
    return np.transpose(t, (2, 3, 0, 1))


def _sd(sd, prefix):
    """Sub-dict view with prefix stripped."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _conv_entry(sd, torch_key):
    entry = {"kernel": conv_w(sd[f"{torch_key}.weight"])}
    if f"{torch_key}.bias" in sd:
        entry["bias"] = sd[f"{torch_key}.bias"]
    return {"Conv_0": entry}


def convert_pwcnet(sd: Dict[str, np.ndarray]) -> dict:
    out = {}
    pyramid = [f"conv{l}{s}" for l in range(1, 6) for s in ("a", "aa", "b")]
    pyramid += ["conv6aa", "conv6a", "conv6b"]
    dense = [f"conv{l}_{i}" for l in (2, 3, 4, 5, 6) for i in range(5)]
    dc = [f"dc_conv{i}" for i in range(1, 7)]
    for name in pyramid + dense + dc:
        out[name] = {"conv": _conv_entry(sd, f"{name}.0")}
    for lvl in (2, 3, 4, 5, 6):
        out[f"predict_flow{lvl}"] = {"conv": _conv_entry(sd, f"predict_flow{lvl}")}
        out[f"deconv{lvl}"] = {"deconv": {
            "kernel": deconv_w(sd[f"deconv{lvl}.weight"]),
            "bias": sd[f"deconv{lvl}.bias"]}}
        if lvl > 2:
            out[f"upfeat{lvl}"] = {"deconv": {
                "kernel": deconv_w(sd[f"upfeat{lvl}.weight"]),
                "bias": sd[f"upfeat{lvl}.bias"]}}
    out["dc_conv7"] = {"conv": _conv_entry(sd, "dc_conv7")}
    return out


_MONONET_IDX = [(0, "in_conv"), (2, "down1"), (5, "down2"), (8, "down3"),
                (11, "down4"), (14, "down5"), (17, "mid"), (20, "up1"),
                (23, "up2"), (26, "up3"), (29, "up4"), (32, "up5")]


def convert_mononet_trunk(sd: Dict[str, np.ndarray]) -> dict:
    return {name: {"conv": _conv_entry(sd, str(idx))}
            for idx, name in _MONONET_IDX}


def convert_branch_head(sd: Dict[str, np.ndarray]) -> dict:
    return {"conv1": _conv_entry(sd, "0"), "conv2": _conv_entry(sd, "2")}


def _res_block(sd, name):
    return {"conv1": _conv_entry(sd, f"{name}.conv1"),
            "conv2": _conv_entry(sd, f"{name}.conv2")}


def convert_s2df(sd: Dict[str, np.ndarray], num_blocks: int = 3) -> dict:
    out = {"block1_conv": _conv_entry(sd, "block1.0")}
    for i in range(2, num_blocks + 1):
        out[f"block{i}"] = _res_block(sd, f"block{i}")
    return out


def convert_resblock(sd: Dict[str, np.ndarray], num_blocks: int = 4) -> dict:
    out = convert_s2df(sd, num_blocks)
    out["block5_conv"] = _conv_entry(sd, "block5.0")
    return out


def convert_megadepth(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """The nested-Sequential indices are the spec traversal path
    (``3.0.1.2.weight`` <-> ``n_3_0_1_2``).  Returns (params, batch_stats)."""
    params: dict = {}
    stats: dict = {}
    for key, val in sd.items():
        *idx, leaf = key.split(".")
        name = "n_" + "_".join(idx)
        if leaf == "weight" and val.ndim == 4:
            params.setdefault(name, {})["kernel"] = conv_w(val)
        elif leaf == "weight":                      # BN affine scale
            params.setdefault(name, {})["scale"] = val
        elif leaf == "bias":                        # conv or BN bias
            params.setdefault(name, {})["bias"] = val
        elif leaf == "running_mean":
            stats.setdefault(name, {})["mean"] = val
        elif leaf == "running_var":
            stats.setdefault(name, {})["var"] = val
        elif leaf != _NO_COUNTERPART:
            raise KeyError(f"unmapped MegaDepth key {key}")
    return params, stats


# reference child name -> (flax name, key map)
_SECTIONS = [("initScaleNets_filter", "filter_net", convert_mononet_trunk),
             ("initScaleNets_filter1", "filter_head1", convert_branch_head),
             ("initScaleNets_filter2", "filter_head2", convert_branch_head),
             ("flownets", "flownets", convert_pwcnet),
             ("rectifyNet", "rectify_net", convert_resblock),
             ("ctxNet", "ctx_net", convert_s2df)]


def convert_dain_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """Map a reference DAIN(_slowmotion) state_dict onto the flax variable
    tree; sections the state_dict lacks are absent."""
    params: dict = {}
    out = {"params": params}
    for ref_name, flax_name, convert in _SECTIONS:
        sub = _sd(sd, ref_name)
        if sub:
            params[flax_name] = convert(sub)
    sub = _sd(sd, "depthNet")
    if sub:
        params["depth_net"], stats = convert_megadepth(sub)
        out["batch_stats"] = {"depth_net": stats}
    return out


class _Tagged(np.ndarray):
    """ndarray that keeps a ``.key`` attribute through views (a transpose
    is a view, so ``__array_finalize__`` runs)."""
    def __array_finalize__(self, obj):
        if obj is not None:
            self.key = getattr(obj, "key", None)


def _tagged_index_sd(reference_sd):
    out = {}
    for k, v in reference_sd.items():
        shape = tuple(np.asarray(v).shape)
        a = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
        a = a.view(_Tagged)
        a.key = k
        out[k] = a
    return out


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def _lookup(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def invert_dain_state_dict(
        variables: dict,
        reference_sd: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray],
                                                      list]:
    """Export flax ``variables`` ({"params": ..., "batch_stats": ...}) into
    the layout of ``reference_sd`` (only its keys and shapes are read).

    Returns ``(state_dict, missing)``: every reference key whose flax
    counterpart exists, as float32 in the reference layout, and the
    reference keys with none."""
    idx_tree = convert_dain_state_dict(_tagged_index_sd(reference_sd))
    out: Dict[str, np.ndarray] = {}
    for path, idx_leaf in _flatten(idx_tree):
        val = _lookup(variables, path)
        if val is None:
            continue
        val = np.asarray(val, np.float32)
        if val.shape != idx_leaf.shape:
            continue          # a variant of another shape (filtered load)
        orig = np.empty(np.asarray(reference_sd[idx_leaf.key]).shape,
                        np.float32)
        orig.ravel()[np.asarray(idx_leaf).ravel()] = val.ravel()
        out[idx_leaf.key] = orig
    missing = [k for k in reference_sd if k not in out]
    return out, missing


def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` as a reference checkpoint holds it: the
    port's keys are the reference's, and PWC-Net's ``deconv2``, which nothing
    calls, is added as zeros, so the JAX package's converter reads the
    result."""
    sd = dict(model.state_dict())
    if any(k.startswith("flownets.") for k in sd):
        sd.update({k: torch.zeros(s) for k, s in _PWC_DECONV2.items()})
    return sd


def load_jax_variables(model: nn.Module, variables: dict) -> list[str]:
    """Load the flax ``variables`` tree (numpy arrays, e.g. from
    ``jax.device_get(DAIN().init(...))``) into ``model`` and return the
    loaded keys.  Raises if any of the model's keys has no counterpart,
    except the BN ``num_batches_tracked`` counters, which keep the model's
    own values."""
    state = model.state_dict()
    template = {k: v.detach().cpu().numpy()
                for k, v in reference_state_dict(model).items()}
    sd, missing = invert_dain_state_dict(variables, template)
    missing = [k for k in missing if k not in _PWC_DECONV2
               and not k.endswith(_NO_COUNTERPART)]
    if missing:
        raise KeyError(f"no counterpart in the JAX variables for {missing}")
    loaded = sorted(k for k in sd if k not in _PWC_DECONV2)
    state.update({k: torch.from_numpy(sd[k]) for k in loaded})
    model.load_state_dict(state)
    return loaded
