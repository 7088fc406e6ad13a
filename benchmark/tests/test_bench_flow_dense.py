"""K10's work and its roofline reader, on the CPU: the dense-block convs'
operations and bytes counted by hand at cell 1's and cell 2's decodes, the
decode's shape from the running cell, and the reader's silence where it
has nothing to read (a program without K10, another cell, a partial
decode)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import evalcell  # noqa: E402
from benchmark.lib.cell import load_reader, resolve  # noqa: E402
from benchmark.lib.flow_dense import (  # noqa: E402
    LAUNCHES, bound_s, cell_decode, conv_work, convs, running_cell)
from benchmark.lib.trace import DeviceOp, Trace  # noqa: E402

CELLS = ("dain-448x256-f32", "dain_slowmo4x-1280x720-f32",
         "dain-448x256-bf16")
DENSE_IN = {6: 81, 5: 213, 4: 181, 3: 149, 2: 117}


def test_dense_work_by_hand():
    """Level 2 of cell 1's decode holds sum Cin * Cout = 129,216 over its
    five convs; the whole decode is 65.7 GFLOP at 512 x
    320 and 413.6 at 1344 x 768, bound by operations."""
    level2 = [c for c in convs(2, 320, 512) if c[3:] == (80, 128)]
    assert sum(cin * cout for _, cin, cout, _, _ in level2) == 129_216
    assert len(convs(2, 320, 512)) == LAUNCHES == 25
    assert [c[1] for c in convs(2, 320, 512)[::5]] == list(DENSE_IN.values())
    ops = sum(conv_work(*c)[1] for c in convs(2, 320, 512))
    assert ops == pytest.approx(65.66e9, rel=1e-3)
    assert sum(conv_work(*c)[1] for c in convs(2, 768, 1344)) == \
        pytest.approx(413.6e9, rel=1e-3)
    nbytes, ops = conv_work(2, 117, 128, 80, 128)
    assert ops == 2 * 9 * 117 * 128 * 2 * 80 * 128
    assert nbytes == 4 * (2 * 80 * 128 * (117 + 128) + 128 * (9 * 117 + 1))
    assert bound_s(2, 320, 512) == pytest.approx(65.66e9 / 67e12, rel=1e-3)


@pytest.mark.parametrize("cell, decode", [
    ("dain-448x256-f32", (2, 320, 512)), ("dain-448x256-bf16", (2, 320, 512)),
    ("dain_slowmo4x-1280x720-f32", (2, 768, 1344))])
def test_decode_at_the_cells_padded_frame(cell, decode):
    """Both directions of the cell's batch, at the driver's padding."""
    c = resolve(cell)
    mix = c["mix"]
    padded, _ = evalcell.reference_pad(torch.zeros(1, 3, mix["height"],
                                                   mix["width"]))
    assert cell_decode(c) == (2 * mix["batch"], *padded.shape[2:]) == decode


def test_running_cell_from_the_command_line():
    assert running_cell(["--workload", "dain-448x256-f32", "--seed", "1"]) \
        == "dain-448x256-f32"
    assert running_cell(["--seed", "1", "--workload=cell"]) == "cell"
    assert running_cell(["--seed", "1"]) is None


def _k10(count, ns=1_000_000):
    return [DeviceOp(s, s + ns, "void dense_conv_kernel<8>(float const*)", s)
            for s in range(0, count * 2 * ns, 2 * ns)]


@pytest.mark.parametrize("cell", CELLS)
def test_reader_reads_whole_decodes_of_the_running_cell(monkeypatch, cell):
    reader = load_reader("flow_dense.roofline.eval")
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload", cell,
                                      "--seed", "7"])
    t = Trace(2, (0, 10 ** 9), _k10(50), [])
    want = 100 * bound_s(*cell_decode(resolve(cell))) * 2 / (50 * 1e-3)
    assert reader.read(t) == pytest.approx(want)
    assert reader.read(Trace(2, (0, 10 ** 9), _k10(49), [])) is None
    assert reader.read(Trace(2, (0, 10 ** 9), [], [])) is None


def test_reader_silent_outside_its_cells(monkeypatch):
    reader = load_reader("flow_dense.roofline.eval")
    t = Trace(1, (0, 10 ** 9), _k10(25), [])
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload",
                                      "sepconv-1920x1080-f32"])
    assert reader.read(t) is None
    monkeypatch.setattr(sys, "argv", ["pytest"])
    assert reader.read(t) is None
