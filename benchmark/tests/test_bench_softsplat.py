"""The SoftSplat cell: its configuration, traffic and workload resolve, its
reference loads nothing of the program or of JAX, the work count of K12 and
its roofline reader, a sound run of the cell at a small size on the CPU,
and, on the card only, the TF32 control and three faults planted in the
reference's splat fail the cell's limits at the cell's own size."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import check, evalcell  # noqa: E402
from benchmark.lib.cell import load_reader, resolve  # noqa: E402
from benchmark.lib.harness import run_cell  # noqa: E402
from benchmark.lib.softsplat import (bound_s, cell_pair,  # noqa: E402
                                     levels, pair_bound_s, splat_work)
from benchmark.lib.trace import DeviceOp, HostOp, Trace  # noqa: E402
from benchmark.reference import softsplat as ref  # noqa: E402

CELL = "softsplat-1920x1080-f32"
SEED = 2 ** 31 + 123
NEW_METRICS = ("softsplat_metric.device_ms.eval",
               "softsplat_pyramid.device_ms.eval",
               "softsplat_splat.device_ms.eval",
               "softsplat_synthesis.device_ms.eval",
               "softsplat_splat.roofline.eval")
FLOW_METRICS = ("flow_pyramid.device_ms.eval",
                "flow_cost_volume.device_ms.eval",
                "flow_decoder.device_ms.eval", "flow_refine.device_ms.eval",
                "flow_heads.device_ms.eval", "flow_dense.roofline.eval",
                "flow.device_ms.eval", "upsample.device_ms.eval")


def test_the_cell_resolves():
    cell = resolve(CELL)
    assert cell["entry"]["chips"] == 1
    assert cell["config"]["net_name"] == "SoftSplat"
    assert cell["config"]["splat_channels"] == [35, 64, 96]
    assert cell["mix"]["height"] == 1080 and cell["mix"]["width"] == 1920
    assert cell["workload"]["save_which"] == 0
    assert {m["name"] for m in cell["end_to_end"]} == {
        "frames_per_s", "pair_latency_p95_ms", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell["per_layer"]}
    assert set(NEW_METRICS) | set(FLOW_METRICS) <= names
    assert "kernels_roofline.eval" not in names
    assert "rectifier.device_ms.eval" not in names
    assert "local_conv.roofline.eval" not in names
    for name in NEW_METRICS:
        assert load_reader(name).MOVES == "frames_per_s"


def test_reference_imports_nothing_of_the_program_or_jax():
    script = ("import sys, json\nsys.path.insert(0, %r)\n"
              "from benchmark.reference import softsplat\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in "
              "sys.modules})))" % str(ROOT))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"vfidkr_torch", "vfidkr_tpu", "jax", "jaxlib",
                         "flax"}
    text = (ROOT / "benchmark" / "reference" / "softsplat.py").read_text()
    for name in ("vfidkr_torch", "vfidkr_tpu", "import jax", "from jax"):
        assert name not in text


def test_k12_work_by_hand():
    """Level 1 of the 1080p pair: both directions of 1984 x 1152 sources,
    35 channels: (2 x 35 + 3) floats a source, 4 corners x 36 values."""
    nbytes, ops = splat_work(2, 35, 1152, 1984)
    px = 2 * 1152 * 1984
    assert nbytes == 4 * px * 73 and ops == 2 * 4 * 36 * px
    assert bound_s(2, 35, 1152, 1984) == pytest.approx(
        4 * px * 73 / 3.35e12)
    assert levels(2, 1152, 1984, (35, 64, 96)) == [
        (2, 35, 1152, 1984), (2, 64, 576, 992), (2, 96, 288, 496)]
    # about 2.16 GB a pair: 0.64 ms at 3.35 TB/s
    assert pair_bound_s(2, 1152, 1984, (35, 64, 96)) == pytest.approx(
        6.45e-4, rel=1e-2)


def test_roofline_reader_takes_the_cells_padded_shape():
    """K12's shape comes from the cell (the traffic after the driver's
    padding, both directions), not from the program; its two kernels a
    launch, three launches a pair, and the memsets launched inside the
    splat's spans (the entry point's scratch zeroing; one outside them does
    not count); no K12 kernel, a count that is not whole pairs, or no span,
    reads None."""
    cell = resolve(CELL)
    padded, _ = evalcell.reference_pad(torch.zeros(1, 3, 1080, 1920))
    assert cell_pair(cell) == (2, *padded.shape[2:], (35, 64, 96)) == \
        (2, 1152, 1984, (35, 64, 96))
    reader = load_reader("softsplat_splat.roofline.eval")
    names = ("Memset (Device)", "void softmax_splat_scatter_kernel<4>",
             "void softmax_splat_normalize_kernel<4>") * 6
    ops = [DeviceOp(s, s + (100_000 if name.startswith("Memset")
                            else 500_000), name, s)
           for s, name in zip(range(0, 18_000_000, 1_000_000), names)]
    ops.append(DeviceOp(30_000_000, 30_100_000, "Memset (Device)",
                        30_000_000))
    spans = [HostOp(0, 9_000_000, "vfidkr/softsplat/splat", 1),
             HostOp(9_000_000, 18_000_000, "vfidkr/softsplat/splat", 1)]
    t = Trace(2, (0, 10 ** 9), ops, spans)
    assert reader.read(t) == pytest.approx(
        100 * 2 * pair_bound_s(2, 1152, 1984, (35, 64, 96)) / 6.6e-3)
    kernels_only = [o for o in ops if not o.name.startswith("Memset")]
    assert reader.read(Trace(2, (0, 10 ** 9), kernels_only, spans)) == \
        pytest.approx(100 * 2 * pair_bound_s(2, 1152, 1984, (35, 64, 96))
                      / 6e-3)
    assert reader.read(Trace(2, (0, 10 ** 9), kernels_only[:5],
                             spans)) is None
    assert reader.read(Trace(2, (0, 10 ** 9), ops, [])) is None
    assert reader.read(Trace(2, (0, 10 ** 9), [], spans)) is None


def _small():
    cell = resolve(CELL)
    cell["mix"].update(height=64, width=128, frames=5)
    cell["workload"].update(warmup_pairs=1, check_pairs=2)
    return cell


def test_sound_small_run_is_correct_on_the_cpu():
    """The whole run, the look for a card skipped, at 64 x 128 (run at 128
    x 192): the program against the reference on the sampled pairs."""
    result = run_cell(_small(), SEED, 1.0, False, "cpu", time.perf_counter())
    assert result["correct"], result["check"]
    assert result["check"]["u8_mismatch"]["value"] == 0.0


# the faults planted in the reference's splat, each of which the cell's
# limits must catch
def _no_importance(real):
    return lambda x, flow, z: real(x, flow, torch.zeros_like(z))


FAULTS = {
    "summation splatting (e^Z = 1)": ("splat", _no_importance),
    "one corner's weight dropped": ("CORNERS", lambda real: real[:3]),
    "no normalisation": ("normalise", lambda real: lambda num, den: num),
}


@pytest.mark.cuda
def test_control_and_faults_fail_the_limits_at_the_cells_size_on_the_card(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control and the faults are "
                    "read at the cell's own size on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = resolve(CELL)
    limits = cell["workload"]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        run = evalcell.EvalRun(cell, seed, "cuda")
        run.setup()
        win = run.window(3.0, False)
        run.free()
        ok, table = check.verdict(run.check(win), limits)
        print(seed, "sound", table, flush=True)
        assert ok, (seed, table)
        ok, table = check.verdict(run.control(win), limits)
        print(seed, "TF32 control", table, flush=True)
        assert not ok, (seed, table)
        for fault, (attr, plant) in FAULTS.items():
            with monkeypatch.context() as m:
                m.setattr(ref, attr, plant(getattr(ref, attr)))
                ok, table = check.verdict(run.check(win), limits)
            print(seed, fault, table, flush=True)
            assert not ok, (seed, fault, table)
