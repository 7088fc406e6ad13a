"""The benchmark's arithmetic and its data-driven harness, on the CPU:
the idle share over the whole traced window, p95, each kernel's bytes and
operations against hand counts at the paths' shapes, the FLOP counter
against the rectifier's convs counted by hand, cells and metrics found by
file name, and BENCHMARK.json held to the benchmark's contract."""

import json
import math
import re
import statistics
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import check, harness, trace as tr, work  # noqa: E402
from benchmark.lib.cell import BENCH, load_reader, resolve  # noqa: E402
from benchmark.reference import nets  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _trace(ops, window, host=(), units=1):
    host = [tr.HostOp(*h) for h in host]
    return tr.Trace(units, window, [tr.DeviceOp(*o) for o in ops],
                    host, main_thread=1)


# -- the device's idle share -------------------------------------------

def test_idle_share_counts_host_gaps_before_and_after():
    # window 0..100; kernels 20..40 and 30..50 (overlap) and 70..80
    t = _trace([(20, 40, "a", 10), (30, 50, "b", 11), (70, 80, "c", 60)],
               (0, 100))
    assert t.busy_ns() == 40
    assert t.idle_share() == pytest.approx(0.6)
    # the leading gap 0..20 is idle, as the trailing 80..100
    assert sorted(tr.gaps([(20, 50), (70, 80)], 0, 100)) == \
        [(0, 20), (50, 70), (80, 100)]


def test_idle_share_clips_to_the_window():
    t = _trace([(-50, 10, "a", None), (90, 200, "b", None)], (0, 100))
    assert t.busy_ns() == 20
    assert t.idle_share() == pytest.approx(0.8)


def test_top_gaps_name_the_host_operation():
    t = _trace([(20, 30, "k", 5)], (0, 100),
               host=[(0, 100, tr.WINDOW, 1), (40, 95, "aten::copy_", 1),
                     (0, 15, "python_loop", 1), (50, 60, "other", 2)])
    gaps = dict((n, s) for n, s in t.top_gaps())
    assert gaps == {"aten::copy_": pytest.approx(70e-9),
                    "python_loop": pytest.approx(20e-9)}


def test_range_device_time_by_launch():
    ops = [(100, 110, "k1", 5), (110, 130, "k2", 15), (130, 135, "k3", 25),
           (140, 150, "memcpy", 26)]
    host = [(0, 200, tr.WINDOW, 1), (0, 20, "bench/x", 1),
            (20, 30, "bench/y", 1)]
    t = _trace(ops, (0, 200), host, units=2)
    assert t.range_device_ms("bench/x") == pytest.approx(30 / 1e6 / 2)
    assert t.range_device_ms("bench/y") == pytest.approx(15 / 1e6 / 2)
    assert t.range_device_ms("bench/none") is None
    assert t.named_device_ms("k2", "k3") == pytest.approx(25 / 1e6 / 2)
    # launches not linked: no range metric
    t = _trace([(o[0], o[1], o[2], None) for o in ops], (0, 200), host)
    assert t.range_device_ms("bench/x") is None


def test_p95_over_every_pair():
    values = list(range(1, 101))
    assert harness.p95(values) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95(list(range(1, 21))) == 19


# -- bytes and operations of the kernels -------------------------------

N, H, W = 2, 256, 448
PLANE = N * H * W * 4              # one float32 plane of the batch


@pytest.mark.parametrize("name,args,planes", [
    # K1 C=3: image 3, flow 2, filter 16 in, out 3 (PERF.md: 6.57 us)
    ("filter_interpolate_fwd", (None,) * 4 + (N, 3, H, W, 0, H), 24),
    # K7 C=196: 196 + 2 + 16 + 196 (PERF.md: 376.18 MB)
    ("filter_interpolate_ctx", (None,) * 4 + (N, 196, H, W, 0, H, None), 410),
    # K2 unweighted: flow 2 in, sums 3 out (1.37 us); weighted + 1 (1.64)
    ("flow_project_scatter", (None, None, None, N, H, W, 0, H, None), 5),
    ("flow_project_scatter", (None, 1, None, N, H, W, 0, H, None), 6),
    # K3: sums 3 in, flow 2 out (1.37 us)
    ("flow_project_finalize", (None, None, N, H, W, 0, H, None, None), 5),
    # K5 C=3 without the image gradient: 24 in, 18 out (11.50 us)
    ("filter_interpolate_bwd", (None,) * 4 + (None, None, None, N, 3, H, W),
     42),
    # K6: flow 2, g 2 in, gflow 2 out (1.64 us)
    ("flow_project_scatter_bwd", (None, None, None, N, H, W), 6),
    # depth backward without / with the depth gradient (2.19 / 3.01 us)
    ("depth_flow_project_bwd", (None,) * 7 + (N, H, W), 8),
    ("depth_flow_project_bwd", (None,) * 6 + (1, N, H, W), 11),
])
def test_kernel_bytes_by_hand(name, args, planes):
    nbytes, _, prec = work.kernel_work(name, args)
    assert nbytes == planes * PLANE
    assert prec == "float32"


def test_kernel_bounds_match_perf_md():
    k1 = work.bound_s("filter_interpolate_fwd",
                      (None,) * 4 + (N, 3, H, W, 0, H))
    assert k1 * 1e6 == pytest.approx(6.57, abs=0.01)
    k7 = work.bound_s("filter_interpolate_ctx",
                      (None,) * 4 + (N, 196, H, W, 0, H, None))
    assert k7 * 1e6 == pytest.approx(112.29, abs=0.01)


def test_k4_operations_by_hand():
    # one conv of the trunk at (1,128,256,448): 2 * pixels * 128 * 128 * 9
    args = (None, None, None, None, 1, H, W)
    nbytes, ops, prec = work.kernel_work("fused_resblocks", args)
    assert ops == 2 * H * W * 128 * 128 * 9
    assert prec == "bfloat16"
    assert nbytes == 2 * H * W * 128 * 2 + 2 * 9 * 128 * 128
    # the six launches of a call: 205.19 us at 989 TFLOP/s (PERF.md)
    six = 6 * work.bound_s("fused_resblocks", args)
    assert six * 1e6 == pytest.approx(205.19, abs=0.01)


def test_flop_counter_against_the_rectifier_by_hand():
    g = torch.Generator().manual_seed(0)
    P = {}
    specs = [("rectifyNet.block1.0", 128, 45, 7, True)]
    specs += [(f"rectifyNet.block{b}.conv{c}", 128, 128, 3, False)
              for b in (2, 3, 4) for c in (1, 2)]
    specs += [("rectifyNet.block5.0", 3, 128, 3, True)]
    for name, co, ci, k, bias in specs:
        P[name + ".weight"] = torch.randn(co, ci, k, k, generator=g) * 0.01
        if bias:
            P[name + ".bias"] = torch.zeros(co)
    h, w = 64, 96
    x = torch.randn(1, 45, h, w, generator=g)
    counts = work.conv_flops_by_stage(
        lambda: nets._stage("rectifyNet", nets.rectifier, P, x, "float32"),
        nets)
    by_hand = sum(2 * h * w * co * ci * k * k for _, co, ci, k, _ in specs)
    assert counts["rectifyNet"] == by_hand
    assert counts[""] == 0


def test_mfu_and_roofline_share():
    t = _trace([(0, 50, "filter_interpolate_fwd_kernel", 1),
                (50, 100, "filter_interpolate_fwd_kernel", 2)], (0, 200),
               units=2)
    t.extra.update(flops={"flownets": 67e12 * 1e-9 * 50},
                   lane={"flownets": "float32"},
                   launches={"filter_interpolate_fwd": [1, 25e-9]})
    # 50 ns a unit of least time over 100 ns a unit of window
    assert harness.mfu(t) == pytest.approx(50.0)
    assert harness.roofline_share(t) == pytest.approx(50.0)
    # a launch the trace lost: no share
    t.extra["launches"] = {"filter_interpolate_fwd": [2, 25e-9]}
    assert harness.roofline_share(t) is None


# -- the check -----------------------------------------------------------

def test_norm_gap_by_the_worst_leaf():
    want = {"a": torch.ones(4), "b": torch.full((4,), 10.0),
            "c": torch.full((4,), 1e-6)}
    got = dict(want, b=torch.full((4,), 10.1))
    med = statistics.median([2.0, 20.0, 2e-6])
    assert check.norm_gap(got, want) == pytest.approx(0.2 / 20.0, rel=1e-5)
    got = dict(want, c=torch.full((4,), 2e-6))
    assert check.norm_gap(got, want) == pytest.approx(2e-6 / med, rel=1e-5)


def test_verdict():
    ok, table = check.verdict({"x": 1.0, "y": 2.0}, {"x": 1.0, "y": 3.0})
    assert ok and table["y"] == {"value": 2.0, "limit": 3.0}
    assert not check.verdict({"x": 1.1}, {"x": 1.0})[0]
    assert not check.verdict({}, {"x": 1.0})[0]
    assert not check.verdict({"x": math.nan}, {"x": 1.0})[0]


# -- found by name ------------------------------------------------------

def test_cells_and_metrics_found_by_file_name():
    for w in SPEC["workloads"]:
        cell = resolve(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["workload"]["traffic"] == w["traffic"]
        assert cell["mix"]["generator"] in ("clip", "triplets")
        for m in cell["per_layer"]:
            reader = load_reader(m["name"])
            assert (reader.LAYER, reader.UNIT, reader.MOVES) == \
                (m["layer"], m["unit"], m["moves"])
            assert callable(reader.read)
    files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert files == {m["name"] for m in SPEC["per_layer"]}


@pytest.mark.parametrize("change", [
    {"batch": 4}, {"loop": "open"}, {"callers": 2}, {"rate": 30.0},
    {"generator": "triplets"}])
def test_a_clip_mix_the_harness_does_not_run_is_refused(change):
    from benchmark.lib.traffic import check_mix
    mix = json.loads((BENCH / "traffic" / "clip-448x256.json").read_text())
    check_mix(mix, "eval")
    with pytest.raises(ValueError):
        check_mix({**mix, **change}, "eval")


def test_a_triplets_mix_with_a_key_it_does_not_read_is_refused():
    from benchmark.lib.traffic import check_mix
    mix = json.loads(
        (BENCH / "traffic" / "triplets-256x448-b3.json").read_text())
    check_mix(mix, "train")
    with pytest.raises(ValueError):
        check_mix({**mix, "augment": False}, "train")


def test_pin_cpus_keeps_the_last_cpus_allowed():
    import os
    before = os.sched_getaffinity(0)
    try:
        assert harness.pin_cpus(1) == [max(before)]
        assert os.sched_getaffinity(0) == {max(before)}
    finally:
        os.sched_setaffinity(0, before)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        cell = resolve(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e


# -- BENCHMARK.json and the contract ------------------------------------

def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert (ROOT / c["file"]).is_file()
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[key]}) == len(SPEC[key])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c for c, _ in pairs} == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e


def test_shares_are_named_as_the_contract_asks():
    for m in SPEC["per_layer"]:
        if "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
