"""The check's control and faults: the rest of a run, with the look for a
card skipped (on the CPU, at a small size), must come out not correct when
the timed path is broken underneath, and correct when it is not; the
control (the reference in the precision below the configuration's, in the
program's place) must fail the cell's limits.  The card-only test reads
the control at each cell's own size."""

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import check, evalcell, traincell  # noqa: E402
from benchmark.lib.cell import resolve  # noqa: E402
from benchmark.lib.harness import run_cell  # noqa: E402

SEED = 2 ** 31 + 99
EVAL, TRAIN = "dain-448x256-f32", "dain-448x256-train-b3-f32"
SLOWMO_TRAIN = "dain_slowmo2x-448x256-train-b3-f32"


def _small(name):
    cell = resolve(name)
    if cell["workload"]["mode"] == "eval":
        cell["mix"].update(height=64, width=128, frames=5)
        cell["workload"].update(warmup_pairs=1, check_pairs=2)
    else:
        cell["mix"].update(height=64, width=64, pool=8, batch=2)
    return cell


def _run(cell, seconds=1.0):
    return run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter())


def test_sound_eval_run_is_correct():
    assert _run(_small(EVAL))["correct"]


def test_eval_answer_altered_is_caught(monkeypatch):
    real = evalcell.frames_between

    def altered(model, a, b, pads, save_which):
        out = real(model, a, b, pads, save_which)
        return (out.int() + 2).clamp(0, 255).to(torch.uint8)

    monkeypatch.setattr(evalcell, "frames_between", altered)
    result = _run(_small(EVAL))
    assert not result["correct"]
    assert result["check"]["u8_mismatch"]["value"] > 0.5


@pytest.mark.parametrize("name", [TRAIN, SLOWMO_TRAIN])
def test_sound_train_run_is_correct(name):
    assert _run(_small(name))["correct"]


def _broken_step(kind):
    real = traincell.train_step

    def step(model, opt, batch, config):
        if kind == "unchanged":
            from vfidkr_torch.training.train_state import eval_step
            model.train()
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                m = eval_step(model, batch, config)
            return m
        if kind == "half_batch":
            half = batch["x0"].shape[0] // 2
            return real(model, opt, {k: v[:half] for k, v in batch.items()},
                        config)
        m = real(model, opt, batch, config)
        return dict(m, total=m["total"] * 1.01)           # "loss_altered"
    return step


@pytest.mark.parametrize("name", [TRAIN, SLOWMO_TRAIN])
@pytest.mark.parametrize("kind,number", [("unchanged", "change_median_gap"),
                                         ("half_batch", "loss1_gap"),
                                         ("loss_altered", "loss1_gap")])
def test_train_faults_are_caught(monkeypatch, name, kind, number):
    monkeypatch.setattr(traincell, "train_step", _broken_step(kind))
    result = _run(_small(name))
    assert not result["correct"]
    table = result["check"]
    assert table[number]["value"] > table[number]["limit"]


@pytest.mark.parametrize("name", [EVAL, "dain-448x256-bf16"])
def test_eval_control_fails_the_limits(name):
    cell = _small(name)
    run = (evalcell.EvalRun)(cell, SEED, "cpu")
    run.setup()
    win = run.window(0.5, False)
    run.free()
    ok, table = check.verdict(run.control(win), cell["workload"]["limits"])
    assert not ok, table


def test_bf16_control_in_the_rectifier_alone_fails_the_limits():
    cell = _small("dain-448x256-bf16")
    run = evalcell.EvalRun(cell, SEED, "cpu")
    run.setup()
    win = run.window(0.5, False)
    run.free()
    ok, table = check.verdict(run.control(win, ["rectifyNet"]),
                              cell["workload"]["limits"])
    assert not ok, table


@pytest.mark.parametrize("name", [TRAIN, SLOWMO_TRAIN])
def test_train_control_fails_the_limits(name):
    cell = _small(name)
    run = traincell.TrainRun(cell, SEED, "cpu")
    run.setup()
    run.free()
    ok, table = check.verdict(run.control(), cell["workload"]["limits"])
    assert not ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("name", [EVAL, "dain_slowmo4x-1280x720-f32",
                                  TRAIN, "dain-448x256-bf16",
                                  "dain-448x256-train-b40-f32", SLOWMO_TRAIN])
def test_control_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's "
                    "own size on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = resolve(name)
    Run = (evalcell.EvalRun if cell["workload"]["mode"] == "eval"
           else traincell.TrainRun)
    for seed in (SEED, SEED + 1, SEED + 2):
        run = Run(cell, seed, "cuda")
        run.setup()
        win = run.window(3.0, False)
        run.free()
        ok, table = check.verdict(run.control(win),
                                  cell["workload"]["limits"])
        assert not ok, (seed, table)
        if name == "dain-448x256-bf16":
            ok, table = check.verdict(run.control(win, ["rectifyNet"]),
                                      cell["workload"]["limits"])
            assert not ok, (seed, "rectifyNet", table)
