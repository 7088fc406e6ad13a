"""Finding a cell, its configuration, its traffic mix and its metrics by
name, and building the program's model for it.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (the mix's parameters, read by one of
the generators of ``benchmark.lib.traffic``),
``benchmark/workloads/<cell>.json`` (the cell's lane, mode, how many
units it traces and samples for the check, and the limits of the check)
and ``benchmark/metrics/<metric>.py`` (one reader a per-layer metric).  A
configuration names its plain reference, a file under
``benchmark/reference/`` and a function in it (``"reference": {"file",
"function"}``), which the check and the FLOP count run.  A new cell, mix
or metric is a new file and a new entry, never an edit; a new
configuration is its config file and, where no reference file has its
net, a reference file of its own, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

from benchmark.lib.traffic import check_mix

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(name: str, spec: dict | None = None) -> dict:
    """The cell ``name`` with its files read: {"name", "entry" (its
    BENCHMARK.json entry), "config", "mix", "workload", "end_to_end",
    "per_layer" (the metrics the cell reports), "reference" (the
    configuration's ``Reference``)}."""
    spec = benchmark_spec() if spec is None else spec
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    entry = entries[name]
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    reference = load_reference(config)
    mix = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    check_mix(mix, workload["mode"], f"traffic/{entry['traffic']}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json says {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in
                                  e2e_names else [])]
    return {"name": name, "entry": entry, "config": config, "mix": mix,
            "workload": workload, "end_to_end": e2e, "per_layer": per_layer,
            "reference": reference}


class Reference(NamedTuple):
    """A configuration's plain reference.  ``forward(P, i0, i2, lane,
    config, training=False)`` -> (blends, rectified): lists of one (B,3,H,W)
    frame a synthesised frame, from the weights ``P`` (the reference
    checkpoint's names), the frames (B,3,H,W) in [0, 1], the lane (child
    -> precision) and the configuration; in training the projection leaves
    its holes and the gradients reach the trained children.  ``groups``:
    the file's ``GROUPS``, {group: (parameter-name prefixes, learning
    rate)} of what the trainer trains (none where the file has none)."""
    forward: Callable
    groups: dict


def load_reference(config: dict) -> Reference:
    """The reference that ``config["reference"]`` names: the function
    ``function`` of the file ``file`` under ``benchmark/reference/``.  The
    file is imported as the module ``benchmark.reference.<its stem>``, so
    a reference that builds on ``nets`` shares its stage hook, which the
    FLOP count sets."""
    ref = config["reference"]
    path = BENCH / "reference" / ref["file"]
    if path.parent != BENCH / "reference" or path.suffix != ".py" or \
            not path.is_file():
        raise FileNotFoundError(
            f"configs/{config['name']}.json names the reference file "
            f"{path.relative_to(ROOT)}, which is not a file of "
            f"benchmark/reference/")
    module = importlib.import_module(f"benchmark.reference.{path.stem}")
    forward = getattr(module, ref["function"], None)
    if not callable(forward):
        raise AttributeError(f"configs/{config['name']}.json names the "
                             f"reference {ref['function']!r}, which "
                             f"{path.relative_to(ROOT)} does not define")
    return Reference(forward, getattr(module, "GROUPS", {}))


def load_reader(metric: str):
    """The module ``benchmark/metrics/<metric>.py``: ``LAYER``, ``UNIT``,
    ``MOVES``, optionally ``RANGES`` ({range name: (module path opening it,
    module path closing it)}), and ``read(trace) -> float | None``."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def lane_of(cell: dict) -> dict:
    """child -> precision of the cell's lane, as its configuration states."""
    return cell["config"]["lanes"][cell["workload"]["lane"]]


def build_model(cell: dict, device, seed: int):
    """The program's model of the cell's configuration and lane, built on
    the meta device by the program's own builder, allocated on ``device``
    and loaded (strict) with the weights drawn from ``seed``.  Returns
    (model, shapes): shapes, name -> (shape, dtype), lets the reference
    draw the same weights again."""
    import torch
    from vfidkr_torch.config import ModelConfig

    from benchmark.lib.weights import make_state, shapes_of
    cfg = cell["config"]
    mc = ModelConfig(net_name=cfg["net_name"], time_step=cfg["time_step"],
                     compute_dtype=cell["workload"]["lane"])
    with torch.device("meta"):
        model = mc.build()
    shapes = shapes_of(model)
    state = make_state(shapes, cfg, seed, device)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model, shapes
