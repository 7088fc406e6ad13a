"""The AdaCoF+ cell: its configuration, traffic and workload resolve, its
reference loads nothing of the program or of JAX, the work count of K14,
its roofline reader and the span readers on a synthetic trace, a sound run
of the cell at a small size on the CPU, and, on the card only, the TF32
control and five faults planted in the reference's sampling fail the
cell's limits at the cell's own size."""

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
from benchmark.lib.adacof import (bound_s, cell_shape,  # noqa: E402
                                  sampling_work)
from benchmark.lib.cell import load_reader, resolve  # noqa: E402
from benchmark.lib.harness import run_cell  # noqa: E402
from benchmark.lib.trace import DeviceOp, HostOp, Trace  # noqa: E402
from benchmark.reference import adacof as ref  # noqa: E402

CELL = "adacof_plus-1920x1080-f32"
SEED = 2 ** 31 + 125
NEW_METRICS = ("adacof_unet.device_ms.eval", "adacof_kernels.device_ms.eval",
               "adacof_sampling.device_ms.eval",
               "adacof_sampling.roofline.eval")


def test_the_cell_resolves():
    cell = resolve(CELL)
    assert cell["entry"]["chips"] == 1
    cfg = cell["config"]
    assert cfg["net_name"] == "AdaCoFPlus"
    assert (cfg["kernel_size"], cfg["dilation"]) == (11, 2)
    assert cfg["trained_elements"] == 22_933_219
    assert cell["mix"]["height"] == 1080 and cell["mix"]["width"] == 1920
    assert cell["workload"]["save_which"] == 0
    assert {m["name"] for m in cell["end_to_end"]} == {
        "frames_per_s", "pair_latency_p95_ms", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell["per_layer"]}
    assert set(NEW_METRICS) | {
        "driver.device_ms.eval", "driver.idle_ms.eval", "model.mfu.eval",
        "device.idle_share.eval", "forward.launches.eval",
        "forward.idle_ms.eval"} == names
    for name in NEW_METRICS:
        assert load_reader(name).MOVES == "frames_per_s"


def test_reference_imports_nothing_of_the_program_or_jax():
    script = ("import sys, json\nsys.path.insert(0, %r)\n"
              "from benchmark.reference import adacof\n"
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
    text = (ROOT / "benchmark" / "reference" / "adacof.py").read_text()
    for name in ("vfidkr_torch", "vfidkr_tpu", "import jax", "from jax"):
        assert name not in text


def test_k14_work_by_hand():
    """The 1080p pair at F = 11: (2 (3 x 121 + 3) + 1 + 3) floats a pixel,
    6.73 GB, 2.01 ms at 3.35 TB/s; the operations (2 x 4 x 121 + 2
    multiply-adds a channel a pixel) are 0.2 ms at 67 TFLOP/s."""
    px = 1152 * 1984
    nbytes, ops = sampling_work(1, 3, 1152, 1984, 121)
    assert nbytes == 4 * px * 736 == 6_728_712_192
    assert ops == 2 * px * 3 * 970
    assert bound_s(1, 3, 1152, 1984, 121) == pytest.approx(nbytes / 3.35e12)
    assert bound_s(1, 3, 1152, 1984, 121) == pytest.approx(2.0086e-3,
                                                           rel=1e-4)


def _trace(ops, spans):
    return Trace(2, (0, 10 ** 9), ops, spans)


def test_readers_on_a_synthetic_trace():
    """The span readers count what the program launched inside their spans
    (the U-Net's two, the heads', the sampling's); the roofline reader takes
    K14's shape from the cell (the traffic after the driver's padding, 121
    taps), not from the program, and its device time by kernel name; no K14
    kernel, or a metric listing two shapes, reads None."""
    cell = resolve(CELL)
    padded, _ = evalcell.reference_pad(torch.zeros(1, 3, 1080, 1920))
    assert cell_shape(cell) == (1, 3, *padded.shape[2:], 121) == \
        (1, 3, 1152, 1984, 121)
    names = ["conv_enc", "conv_dec", "conv_head",
             "(anonymous namespace)::adacof_kernel(float const*)"]
    spans, ops = [], []
    for pair in range(2):
        base = pair * 100_000_000
        for k, (span, ms) in enumerate(zip(
                ("vfidkr/adacof/encoder", "vfidkr/adacof/decoder",
                 "vfidkr/adacof/kernels", "vfidkr/adacof/sampling"),
                (10, 6, 150, 4))):
            s = base + k * 20_000_000
            spans.append(HostOp(s, s + 1_000, span, 1))
            ops.append(DeviceOp(s + 2_000, s + 2_000 + ms * 1_000_000,
                                names[k], s + 500))
    t = _trace(ops, spans)
    assert load_reader("adacof_unet.device_ms.eval").read(t) == \
        pytest.approx(16.0)
    assert load_reader("adacof_kernels.device_ms.eval").read(t) == \
        pytest.approx(150.0)
    assert load_reader("adacof_sampling.device_ms.eval").read(t) == \
        pytest.approx(4.0)
    roof = load_reader("adacof_sampling.roofline.eval")
    assert roof.read(t) == pytest.approx(
        100 * bound_s(1, 3, 1152, 1984, 121) / 4e-3)
    assert roof.read(_trace(ops[:3], spans)) is None
    assert load_reader("adacof_sampling.device_ms.eval").read(
        _trace(ops, [])) is None


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
    assert result["check"]["u8_mismatch"]["value"] <= 1e-4


# the faults planted in the reference's sampling, each of which the cell's
# limits must catch
def _no_offsets(real):
    return lambda f, w, a, b, d: real(f, w, torch.zeros_like(a),
                                      torch.zeros_like(b), d)


FAULTS = {
    # the public CuPy kernel's int A = (int) alpha: truncation toward zero
    "the public CuPy arithmetic": ("floor", lambda real: torch.trunc),
    "dilation 1 for 2": ("sampling", lambda real: lambda i0, i2, h, d:
                         real(i0, i2, h, 1)),
    "one bilinear corner dropped": ("CORNERS", lambda real: real[:3]),
    "alpha and beta swapped": ("sample", lambda real: lambda f, w, a, b, d:
                               real(f, w, b, a, d)),
    "offsets zeroed": ("sample", _no_offsets),
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
