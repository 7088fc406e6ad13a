"""The readers of the program's own spans (``benchmark/lib/spans.py`` and
the metrics that use it), on synthetic traces as test_bench_metrics.py
builds them: device time by launch inside spans, the backward spans
widened to their node's evaluation, kernels launched, the idle time split
by the main thread's span, and None from a program without spans."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import spans, trace as tr  # noqa: E402
from benchmark.lib.cell import load_reader  # noqa: E402

MAIN, AUTOGRAD = 1, 2
NEW = ("upsample.device_ms.eval", "flow_pyramid.device_ms.eval",
       "flow_cost_volume.device_ms.eval", "flow_decoder.device_ms.eval",
       "flow_refine.device_ms.eval", "forward.launches.eval",
       "forward.idle_ms.eval", "driver.idle_ms.eval", "loss.device_ms.train",
       "rectifier_bwd.device_ms.train", "flow_bwd.device_ms.train",
       "kernel_unet_bwd.device_ms.train", "warp_bwd.device_ms.train",
       "between_steps.idle_ms.train")


def _trace(ops, window, host, units=1):
    return tr.Trace(units, window, [tr.DeviceOp(*o) for o in ops],
                    [tr.HostOp(*h) for h in host], main_thread=MAIN)


def _pairs(units=2):
    """``units`` pairs of 100 ns, each: forward 10..70 (flow 10..40 with its
    decoder 20..30, upsample 40..50), the driver's finish 70..90."""
    host, ops = [], []
    for u in range(units):
        b = 100 * u
        host += [(b, b + 100, tr.UNIT, MAIN),
                 (b + 10, b + 70, spans.FORWARD, MAIN),
                 (b + 10, b + 40, "vfidkr/flow", MAIN),
                 (b + 20, b + 30, "vfidkr/flow/decoder", MAIN),
                 (b + 40, b + 50, "vfidkr/upsample", MAIN),
                 (b + 70, b + 90, "vfidkr/driver/finish", MAIN)]
        # launched at 22 and 45 (inside), 12 (flow, outside the decoder),
        # 60 (forward, outside the stages) and 75 (the driver)
        ops += [(b + 25, b + 35, "conv_kernel", b + 22),
                (b + 46, b + 50, "upsample_kernel", b + 45),
                (b + 12, b + 20, "pyramid_kernel", b + 12),
                (b + 60, b + 62, "Memset (Device)", b + 60),
                (b + 80, b + 88, "Memcpy DtoH (Device -> Pinned)", b + 75)]
    host.append((0, 100 * units, tr.WINDOW, MAIN))
    return _trace(ops, (0, 100 * units), host, units)


def test_device_time_inside_the_programs_spans():
    t = _pairs()
    assert spans.device_ms(t, "vfidkr/flow/decoder") == pytest.approx(10e-6)
    assert spans.device_ms(t, "vfidkr/upsample") == pytest.approx(4e-6)
    assert load_reader("flow_decoder.device_ms.eval").read(t) == \
        pytest.approx(10e-6)
    assert load_reader("upsample.device_ms.eval").read(t) == \
        pytest.approx(4e-6)
    # nested spans count each launch once
    assert spans.device_ms(t, "vfidkr/flow", "vfidkr/flow/decoder") == \
        pytest.approx(18e-6)


def test_kernels_launched_in_the_forward_leave_copies_and_sets_out():
    t = _pairs(units=3)
    # conv, upsample and pyramid a pair; the set in the forward is no kernel
    assert spans.kernels_launched(t, spans.FORWARD) == 3
    assert load_reader("forward.launches.eval").read(t) == 3


def test_idle_time_split_by_the_forward():
    t = _pairs()
    # busy a pair: 12..20, 25..35, 46..50, 60..62, 80..88 = 32 of 100;
    # idle inside the forward 10..70: 10..12, 20..25, 35..46, 50..60,
    # 62..70 = 36; outside: 0..10, 70..80, 88..100 = 32
    fwd = load_reader("forward.idle_ms.eval").read(t)
    drv = load_reader("driver.idle_ms.eval").read(t)
    assert fwd == pytest.approx(36e-6) and drv == pytest.approx(32e-6)
    idle_ms = t.idle_share() * t.window_ns() / 1e6 / t.units
    assert fwd + drv == pytest.approx(idle_ms)


def test_idle_split_reads_only_the_main_thread():
    t = _pairs(units=1)
    t.host.append(tr.HostOp(0, 100, spans.FORWARD, AUTOGRAD))
    assert spans.idle_split_ns(t, spans.FORWARD) == (36, 32)


def _steps():
    """One step of 200 ns: forward 10..50, loss 50..60, backward 60..150
    (two nodes of the rectifier and one of the loss evaluated on the
    autograd thread, the sums of their gradients after each node's span),
    optimizer 150..170; the read-back and the batch's copy 170..200."""
    host = [(0, 200, tr.WINDOW, MAIN), (0, 200, tr.UNIT, MAIN),
            (0, 10, "vfidkr/train/zero_grad", MAIN),
            (10, 50, spans.FORWARD, MAIN),
            (50, 60, "vfidkr/train/loss", MAIN),
            (60, 150, "vfidkr/train/backward", MAIN),
            (150, 170, "vfidkr/train/optimizer", MAIN)]
    nodes = [(62, 80, "vfidkr/train/loss/backward"),
             (80, 110, "vfidkr/rectifier/backward"),
             (110, 140, "vfidkr/rectifier/backward")]
    ops = [(12, 48, "fwd_kernel", 12), (52, 58, "loss_kernel", 52)]
    for s, e, name in nodes:
        host += [(s, e, spans.EVALUATE + "XBackward0", AUTOGRAD),
                 (s + 1, e - 8, name, AUTOGRAD)]
        ops += [(s + 2, e - 8, "bwd_kernel", s + 2),
                (e - 6, e - 2, "add_kernel", e - 6)]    # the gradient sum
    ops += [(152, 168, "adamax_kernel", 151),
            (185, 190, "Memcpy HtoD (Pinned -> Device)", 180)]
    return _trace(ops, (0, 200), host)


def test_backward_spans_take_their_nodes_gradient_sums():
    t = _steps()
    # loss: 6 forward + 8 + 4 backward; rectifier: (20 + 4) * 2
    assert load_reader("loss.device_ms.train").read(t) == \
        pytest.approx(18e-6)
    assert load_reader("rectifier_bwd.device_ms.train").read(t) == \
        pytest.approx(48e-6)
    # loss and the stages' backward make up the window the hook metric
    # reads, from the forward's return to the optimizer's step
    whole = t.per_unit_ms(t.device_ns(t.launched_in([(50, 150)])))
    assert 18e-6 + 48e-6 == pytest.approx(whole)
    # a backward span with no evaluation around it counts as it is
    t.host = [h for h in t.host if not h.name.startswith(spans.EVALUATE)]
    assert load_reader("rectifier_bwd.device_ms.train").read(t) == \
        pytest.approx(40e-6)


def test_idle_time_between_steps():
    t = _steps()
    # busy: 12..48, 52..58, the backward's 6 kernels, 152..168, 185..190;
    # idle outside the four phases (0..10, 170..200): 0..10, 170..185,
    # 190..200 = 35
    assert load_reader("between_steps.idle_ms.train").read(t) == \
        pytest.approx(35e-6)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_none(name):
    ops = [(10, 20, "k", 5), (30, 40, "k", 25)]
    host = [(0, 100, tr.WINDOW, MAIN), (0, 100, tr.UNIT, MAIN),
            (0, 50, "bench/forward", MAIN)]
    assert load_reader(name).read(_trace(ops, (0, 100), host)) is None
