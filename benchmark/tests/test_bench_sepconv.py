"""The SepConv cell: its configuration, traffic and workload resolve, its
reference loads nothing of the program or of JAX, the work count of K9,
and, on the card only, the TF32 control fails the cell's limits at the
cell's own size."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import check, evalcell  # noqa: E402
from benchmark.lib.cell import load_reader, resolve  # noqa: E402
from benchmark.lib.local_conv import (bound_s, cell_shape,  # noqa: E402
                                      local_conv_work)
from benchmark.lib.trace import DeviceOp, Trace  # noqa: E402

CELL = "sepconv-1920x1080-f32"
SEED = 2 ** 31 + 99
NEW_METRICS = ("sepconv_encoder.device_ms.eval",
               "sepconv_decoder.device_ms.eval",
               "sepconv_kernels.device_ms.eval", "local_conv.device_ms.eval",
               "local_conv.roofline.eval")


def test_the_cell_resolves():
    cell = resolve(CELL)
    assert cell["entry"]["chips"] == 1
    assert cell["config"]["net_name"] == "SepConv"
    assert cell["config"]["filter_size"] == 51
    assert cell["mix"]["height"] == 1080 and cell["mix"]["width"] == 1920
    assert cell["workload"]["save_which"] == 0
    assert {m["name"] for m in cell["end_to_end"]} == {
        "frames_per_s", "pair_latency_p95_ms", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell["per_layer"]}
    assert set(NEW_METRICS) <= names
    assert "kernels_roofline.eval" not in names
    assert "rectifier.device_ms.eval" not in names
    for name in NEW_METRICS:
        assert load_reader(name).MOVES == "frames_per_s"


def test_reference_imports_nothing_of_the_program_or_jax():
    script = ("import sys, json\nsys.path.insert(0, %r)\n"
              "from benchmark.reference import sepconv\n"
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
    text = (ROOT / "benchmark" / "reference" / "sepconv.py").read_text()
    for name in ("vfidkr_torch", "vfidkr_tpu", "import jax", "from jax"):
        assert name not in text


def test_k9_work_at_the_cells_size():
    nbytes, ops = local_conv_work(1, 3, 1152, 1984, 51)
    assert ops == 4 * 3 * 1152 * 1984 * 2652
    assert nbytes == 4 * 1152 * 1984 * (6 + 4 * 51 + 3)
    # bound by the operations: 72.7 GFLOP at 67 TFLOP/s
    assert bound_s(1, 3, 1152, 1984, 51) == pytest.approx(1.0857e-3,
                                                          rel=1e-3)


def test_roofline_reader_takes_the_cells_padded_shape():
    """K9's shape comes from the cell (the traffic after the driver's
    padding), not from the program; with no K9 launch it reads None."""
    cell = resolve(CELL)
    padded, _ = evalcell.reference_pad(torch.zeros(1, 3, 1080, 1920))
    assert cell_shape(cell) == (1, 3, *padded.shape[2:], 51) == \
        (1, 3, 1152, 1984, 51)
    reader = load_reader("local_conv.roofline.eval")
    k9 = [DeviceOp(s, s + 2_000_000, "void sepconv_pair_kernel<>", s)
          for s in (0, 5_000_000)]
    t = Trace(2, (0, 10 ** 9), k9, [])
    assert reader.read(t) == pytest.approx(
        100 * bound_s(1, 3, 1152, 1984, 51) / 2e-3)
    assert reader.read(Trace(2, (0, 10 ** 9), [], [])) is None


@pytest.mark.cuda
def test_control_fails_the_limit_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's "
                    "own size on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = resolve(CELL)
    for seed in (SEED, SEED + 1, SEED + 2):
        run = evalcell.EvalRun(cell, seed, "cuda")
        run.setup()
        win = run.window(3.0, False)
        run.free()
        ok, table = check.verdict(run.control(win),
                                  cell["workload"]["limits"])
        print(seed, table)
        assert not ok, (seed, table)
