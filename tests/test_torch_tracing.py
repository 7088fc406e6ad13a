"""The port's profiler spans (``vfidkr_torch.utils.profiling``), on the CPU.

Without a profiler ``span`` is one shared no-op and nothing is hooked.
Under ``torch.profiler``: every ATen op of a DAIN and a DAINSlowMotion
forward lies in exactly one stage span inside ``vfidkr/forward``, PWC-Net's
four parts inside ``vfidkr/flow``; the driver's ``to_input`` and
``frames_between`` show their spans; in a traced ``train_step`` each
backward node's evaluation (but ``AccumulateGrad``'s) holds exactly one
``<stage>/backward`` span, the phases show once a step, and the hooks go
with the graph; ``utils.trace``'s Chrome trace holds the spans.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfidkr_torch.apps.interpolate_video import (  # noqa: E402
    frames_between, to_input)
from vfidkr_torch.models import DAIN, DAINSlowMotion  # noqa: E402
from vfidkr_torch.training import (TrainConfig, make_optimizer,  # noqa: E402
                                   train_step)
from vfidkr_torch.utils import profiling  # noqa: E402

H = W = 64
STAGES = ("vfidkr/depth", "vfidkr/context", "vfidkr/kernel_unet",
          "vfidkr/flow", "vfidkr/upsample", "vfidkr/projection",
          "vfidkr/filter_warp", "vfidkr/rectifier")
FLOW_PARTS = ("vfidkr/flow/pyramid", "vfidkr/flow/cost_volume",
              "vfidkr/flow/decoder", "vfidkr/flow/refine")
PHASES = ("vfidkr/train/zero_grad", "vfidkr/train/loss",
          "vfidkr/train/backward", "vfidkr/train/optimizer")
EVALUATE = "autograd::engine::evaluate_function: "


def _model(net):
    g = torch.Generator().manual_seed(0)
    if net == "DAIN":
        return DAIN(generator=g, init_unused=False)
    return DAINSlowMotion(timestep=0.25, generator=g)


def _frames(n=2, b=1):
    g = torch.Generator().manual_seed(1)
    return [torch.rand(b, 3, H, W, generator=g) for _ in range(n)]


def _host_events(prof):
    """(start ns, end ns, thread, name) of every host event, by start."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU)


def _inside(ev, outer) -> bool:
    return (ev[2] == outer[2] and outer[0] <= ev[0]
            and ev[1] <= outer[1])


def _named(events, *names):
    return [e for e in events if e[3] in names]


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("a") is profiling.span("b") is profiling.OFF
    with profiling.span("a") as s:
        s.outputs(torch.ones(1, requires_grad=True) * 2)
    with _cpu_profile():
        live = profiling.span("a")
        assert live is not profiling.OFF
        with live:
            pass
    assert profiling.span("a") is profiling.OFF


@pytest.fixture
def counted(monkeypatch):
    """Counts of spans opened and autograd nodes hooked."""
    seen = {"spans": 0, "hooks": 0}
    span_cls, hook = profiling._Span, profiling._hook

    def opened(name):
        seen["spans"] += 1
        return span_cls(name)

    def hooked(node, label):
        seen["hooks"] += 1
        hook(node, label)

    monkeypatch.setattr(profiling, "_Span", opened)
    monkeypatch.setattr(profiling, "_hook", hooked)
    return seen


def _batch(b=1):
    x0, x1, y = _frames(3, b)
    return {"x0": x0, "x1": x1, "y": y}


def test_untraced_forward_and_step_open_no_span_and_hook_nothing(counted):
    model = _model("DAIN").train()
    out = model(*_frames())
    out["outputs"][1].mean().backward()
    train_step(model, make_optimizer(model, TrainConfig()), _batch(),
               TrainConfig())
    assert counted == {"spans": 0, "hooks": 0}


@pytest.mark.parametrize("net", ["DAIN", "DAINSlowMotion"])
def test_every_forward_op_lies_in_exactly_one_stage(net):
    model = _model(net).eval()
    with torch.inference_mode(), _cpu_profile() as prof:
        model(*_frames())
    ev = _host_events(prof)
    (fwd,) = _named(ev, "vfidkr/forward")
    stages = _named(ev, *STAGES)
    assert all(_inside(s, fwd) for s in stages)
    steps = 3 if net == "DAINSlowMotion" else 1
    want = {"vfidkr/kernel_unet": 1, "vfidkr/flow": 1,
            "vfidkr/upsample": steps, "vfidkr/projection": steps,
            "vfidkr/filter_warp": steps, "vfidkr/rectifier": steps}
    if net == "DAINSlowMotion":
        want.update({"vfidkr/depth": 1, "vfidkr/context": 1})
    assert {n: len(_named(stages, n)) for n in want} == want
    assert len(stages) == sum(want.values())
    ops = [e for e in ev if e[3].startswith("aten::") and _inside(e, fwd)]
    assert len(ops) > 100
    for op in ops:
        assert sum(_inside(op, s) for s in stages) == 1, op
    (flow,) = _named(stages, "vfidkr/flow")
    parts = _named(ev, *FLOW_PARTS)
    assert all(_inside(p, flow) for p in parts)
    # the pyramid once, five levels of cost volume and decoder, the refine
    assert [len(_named(parts, n)) for n in FLOW_PARTS] == [1, 5, 5, 1]
    # only the views splitting the two directions lie outside the parts
    views = _named(ev, "aten::slice")
    for op in ops:
        if _inside(op, flow) and not any(_inside(op, v) for v in views):
            assert sum(_inside(op, p) for p in parts) == 1, op


def test_driver_spans():
    model = _model("DAIN").eval()
    frame = (np.random.RandomState(2).rand(48, 56, 3) * 255).astype(np.uint8)
    with _cpu_profile() as prof:
        a, pads = to_input(frame, "cpu")
        b, _ = to_input(frame[::-1].copy(), "cpu")
        out = frames_between(model, a, b, pads)
    assert out.shape == (1, 48, 56, 3) and out.dtype == torch.uint8
    ev = _host_events(prof)
    inputs = _named(ev, "vfidkr/driver/to_input")
    (fwd,), (finish,) = (_named(ev, "vfidkr/forward"),
                         _named(ev, "vfidkr/driver/finish"))
    assert len(inputs) == 2 and all(s[1] <= fwd[0] for s in inputs)
    assert fwd[1] <= finish[0]
    for span in inputs + [finish]:
        assert any(e[3].startswith("aten::") and _inside(e, span)
                   for e in ev)


def _traced_step(model, opt):
    with _cpu_profile() as prof:
        train_step(model, opt, _batch(2), TrainConfig())
    return _host_events(prof)


def test_train_step_phases_and_per_stage_backward(counted):
    model = _model("DAIN").train()
    opt = make_optimizer(model, TrainConfig())
    counts = []
    for _ in range(2):
        ev = _traced_step(model, opt)
        assert [len(_named(ev, n)) for n in PHASES] == [1, 1, 1, 1]
        (fwd,) = _named(ev, "vfidkr/forward")
        zero, loss, back, step = (_named(ev, n)[0] for n in PHASES)
        assert zero[1] <= fwd[0] and fwd[1] <= loss[0]
        assert loss[1] <= back[0] and back[1] <= step[0]
        bwd = [e for e in ev if e[3].endswith("/backward")
               and e[3] != "vfidkr/train/backward"]
        evals = [e for e in ev if e[3].startswith(EVALUATE)
                 and "AccumulateGrad" not in e[3]]
        assert len(evals) > 100
        for e in evals:
            held = [s for s in bwd if _inside(s, e)]
            assert len(held) == 1, e
            node = e[3][len(EVALUATE):]
            assert any(x[3] == node and _inside(x, held[0]) for x in ev), e
        assert all(any(_inside(s, e) for e in evals) for s in bwd)
        names = {s[3] for s in bwd}
        assert names == {f"{n}/backward" for n in (
            "vfidkr/kernel_unet", "vfidkr/flow", "vfidkr/upsample",
            "vfidkr/projection", "vfidkr/filter_warp", "vfidkr/rectifier",
            "vfidkr/train/loss")}
        counts.append((len(bwd), counted["hooks"]))
    # the second step hooks as many nodes and opens as many spans: the
    # first step's hooks went with its graph
    assert counts[1] == (counts[0][0], 2 * counts[0][1])
    assert counts[0][0] == counts[0][1]
    before = dict(counted)
    train_step(model, opt, _batch(2), TrainConfig())
    assert counted == before


def test_trace_writes_the_stage_spans(tmp_path):
    model = _model("DAIN").eval()
    with torch.inference_mode(), profiling.trace(str(tmp_path / "prof")):
        model(*_frames())
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"vfidkr/forward", *FLOW_PARTS} <= names
    assert set(STAGES) - {"vfidkr/depth", "vfidkr/context"} <= names
