"""What a run loads: the harness, its traffic and its metric readers load
no module of JAX or of the JAX package, the reference loads nothing of the
program, and a run that finds no card fails without a result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "vfidkr_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    script = (f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "import json\nprint(json.dumps(sorted({m.split('.')[0] for m "
              "in sys.modules})))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_traffic_and_readers_load_no_jax():
    code = """
import importlib.util, json, pathlib
spec = importlib.util.spec_from_file_location("bench_run", "benchmark/run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from benchmark.lib import cell, evalcell, traincell, harness, traffic, trace
from benchmark.lib.cell import benchmark_spec, load_reader, resolve
for m in benchmark_spec()["per_layer"]:
    load_reader(m["name"])
for w in benchmark_spec()["workloads"]:
    resolve(w["name"])
import vfidkr_torch.apps.interpolate_video, vfidkr_torch.training.train_state
import vfidkr_torch.data.native, vfidkr_torch.data.vimeo90k
"""
    loaded = _loaded(code)
    assert "vfidkr_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("from benchmark.reference import nets, ops, train")
    assert "vfidkr_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("vfidkr_torch", "vfidkr_tpu", "import jax", "from jax"):
            assert name not in text, (path, name)


def test_forbidden_modules_compare_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run2",
                                                  ROOT / "benchmark/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    saved = dict(sys.modules)
    try:
        sys.modules["vfidkr_torch_like"] = object()
        sys.modules["jaxtyping"] = object()
        assert not set(run.forbidden_modules()) & {"vfidkr_torch_like",
                                                     "jaxtyping"}
        sys.modules["jax.numpy"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_without_a_card_fails_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs none")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dain-448x256-f32",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr
