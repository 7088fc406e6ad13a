"""The benchmark's plain reference held to the program on the CPU at a
small size: each configuration's named reference against the program's
forward (DAIN and DAIN_slowmotion, both lanes), and one train step's loss
and gradients of each training cell's configuration (DAIN, and
DAIN_slowmotion at t = 0.5 with its frozen nets).  On CPU tensors the
program runs its kernels' plain versions, so the two agree to float32
rounding.  A configuration naming a reference that is not there fails
when its cell is resolved."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import cell as cell_lib, traffic  # noqa: E402
from benchmark.lib.cell import build_model, lane_of, resolve  # noqa: E402
from benchmark.lib.weights import make_state  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

SEED = 2 ** 33 + 7


def _cell(name, **mix):
    cell = resolve(name)
    cell["mix"].update(mix)
    return cell


def _frames(cell, h, w):
    clip = traffic.make_clip(dict(cell["mix"], height=h, width=w, frames=3),
                             SEED, "cpu")
    to = lambda f: torch.from_numpy(f).permute(2, 0, 1)[None].float() / 255
    return to(clip[0]), to(clip[1])


@pytest.mark.parametrize("name,rtol", [("dain-448x256-f32", 1e-5),
                                       ("dain-448x256-bf16", 1e-5),
                                       ("dain_slowmo4x-1280x720-f32", 1e-5)])
def test_forward_matches_program(name, rtol):
    torch.manual_seed(0)
    cell = _cell(name)
    model, shapes = build_model(cell, "cpu", SEED)
    model.eval()
    P = make_state(shapes, cell["config"], SEED, "cpu")
    i0, i2 = _frames(cell, 64, 128)
    cfg = cell["config"]
    with torch.no_grad():
        got = model(i0, i2)["outputs"]
        want = cell["reference"].forward(P, i0, i2, lane_of(cell), cfg)
    flat = lambda outs: [t for o in outs for t in
                         (o if isinstance(o, list) else [o])]
    got, want = flat(got), flat(want)
    assert len(got) == len(want) == 2 * cfg["frames_a_pair"]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= \
            rtol * max(1.0, b.abs().max().item())
    # the rectified frame carries a picture: neither saturated nor flat
    rect = want[-1]
    inside = ((rect > 0) & (rect < 1)).float().mean().item()
    assert inside > 0.8 and rect.std().item() > 0.05


@pytest.mark.parametrize("name", ["dain-448x256-train-b3-f32",
                                  "dain_slowmo2x-448x256-train-b3-f32"])
def test_train_step_gradients_match_program(name):
    from vfidkr_torch.training.train_state import (TrainConfig,
                                                   make_optimizer, train_step)
    cell = _cell(name, height=64, width=64, pool=4, batch=2)
    model, shapes = build_model(cell, "cpu", SEED)
    model.train()
    opt = make_optimizer(model, TrainConfig())
    pool = traffic.make_triplets(cell["mix"], SEED, "cpu")
    idx, records = traffic.batch_plan(cell["mix"], SEED, 1)[0]
    samples = [traffic.augment_plain(pool[i], r) for i, r in zip(idx, records)]
    batch = {k: torch.stack([s[k] for s in samples]) for k in ("x0", "x1", "y")}
    P = make_state(shapes, cell["config"], SEED, "cpu")
    reference = cell["reference"]
    leaves = list(ref_train.trained(P, reference.groups))
    loss, grads = ref_train.loss_and_grads(reference, cell["config"], P,
                                           batch, lane_of(cell), leaves)
    m = train_step(model, opt, batch, TrainConfig())
    assert abs(float(m["total"]) - loss) <= 1e-5 * abs(loss)
    named = dict(model.named_parameters())
    assert set(leaves) == {n for g in opt.param_groups for n, p in
                           named.items() if any(p is q for q in g["params"])}
    norms = sorted(float(g.norm()) for g in grads.values())
    med = norms[len(norms) // 2]
    for k in leaves:
        diff = (named[k].grad - grads[k]).norm().item()
        assert diff <= 1e-4 * max(grads[k].norm().item(), med), k


@pytest.mark.parametrize("file,function", [("absent.py", "dain"),
                                           ("../lib/cell.py", "resolve"),
                                           ("nets.py", "absent")])
def test_a_configuration_naming_a_missing_reference_fails_in_resolve(
        monkeypatch, file, function):
    real = cell_lib.load_json

    def load(path):
        out = real(path)
        if path.parent.name == "configs" and path.stem == "dain":
            out["reference"] = {"file": file, "function": function}
        return out

    monkeypatch.setattr(cell_lib, "load_json", load)
    with pytest.raises((FileNotFoundError, AttributeError)) as err:
        resolve("dain-448x256-f32")
    assert "configs/dain.json" in str(err.value)
    assert f"benchmark/reference/{file}" in str(err.value)


def test_reference_adamax_is_torch_adamax():
    g = torch.Generator().manual_seed(0)
    p = torch.randn(5, 7, generator=g)
    grads = [torch.randn(5, 7, generator=g) for _ in range(3)]
    t = p.clone().requires_grad_()
    opt = torch.optim.Adamax([t], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    P = {"w": p.clone()}
    mine = ref_train.Adamax({"w": 1e-3})
    for gr in grads:
        t.grad = gr.clone()
        opt.step()
        mine.step(P, {"w": gr})
    torch.testing.assert_close(P["w"], t.detach(), rtol=1e-6, atol=1e-7)
