"""The metric readers on a recorded fake trace, and the harness's refusal
to print a result line that lacks a declared metric."""

import json
import math
from pathlib import Path

import pytest

from benchmark import roofline, run, trace

BENCH = Path(__file__).resolve().parents[1]
DOC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CONF = json.loads((BENCH / "configs" / "qwen2-7b-int8.json").read_text())

W8 = "void wonly_tile_kernel<(anonymous namespace)::W8Tile, 2, true>(...)"
W4 = "void wonly_tile_kernel<(anonymous namespace)::W4Tile, 2, true>(...)"
SPLIT = "void split_sum_kernel<__nv_bfloat16>(...)"
K2 = "void prefill_tc_kernel<2>(...)"


def fake_ctx():
    """Two tiles (one split-summed), one K2 call and a copy in a 10 ms
    window; one forward of 2 x 3 rows, 4 valid, at the 7B widths."""
    device = [(W8, 0.000, 0.002), (SPLIT, 0.002, 0.0025), (W4, 0.003, 0.004),
              ("Memcpy HtoD", 0.0045, 0.005), (K2, 0.006, 0.007)]
    host = [("bench.frontend", 0.0, 0.003), ("bench.tick_submit", 0.003, 0.008),
            ("bench.deliver", 0.008, 0.010)]
    tr = trace.summarize(sorted(device, key=lambda x: x[1]), host, 0.0, 0.010)
    linear = [("k1", 6, 3584, 3584), ("k5", 6, 3584, 18944)]
    launches = {"forwards": [{"valid": 4, "linear": linear,
                              "k2": [((2, 3, 28, 128), [(0, [90, 91]), (1, [95, 96])])]}],
                "frontends": [((2, 32, 80), 2)]}
    return {"setup_s": 12.5, "window_s": 30.0,
            "win": {"stream_rate": 101.5, "latencies": [0.1 * i for i in range(40)]},
            "spans": {"step": [0.5, 0.7], "frontend": [0.1, 0.3],
                      "dispatch": [0.2, 0.2]},
            "trace": tr, "launches": launches, "dims": CONF["dims"],
            "precision": CONF["precision"]}


def test_trace_summary():
    tr = fake_ctx()["trace"]
    assert math.isclose(tr["busy_s"], 0.0025 + 0.001 + 0.0005 + 0.001)
    assert tr["window_s"] == 0.010
    gaps = [round(e - s, 6) for s, e in tr["gaps"]]
    assert gaps == [0.0005, 0.0005, 0.001, 0.003]
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == W8
    assert bd["idle_gaps"][0] == ["bench.tick_submit", pytest.approx(0.003)]


def test_family_split_sum_follows_its_tile():
    fams = roofline.family_seconds(fake_ctx()["trace"]["device"])
    assert fams["k1"] == pytest.approx(0.0025)
    assert fams["k5"] == pytest.approx(0.001)
    assert fams["k2"] == pytest.approx(0.001)


EXPECTED = {
    "setup_s": 12.5, "stream_rate": 101.5,
    "step_ms.overload": 600.0, "step_ms.live": 600.0,
    "frontend_ms.overload": 200.0, "frontend_ms.live": 200.0,
    "dispatch_ms.overload": 200.0, "dispatch_ms.live": 200.0,
    "device_idle.overload": 50.0, "device_idle.live": 50.0,
    "decision_p95_ms": 3705.0,
    "k1_roofline": 100.0 * roofline.linear_bound(4, 3584, 3584, 8, 64) / 0.0025,
    "k5_roofline": 100.0 * roofline.linear_bound(4, 3584, 18944, 4, 64) / 0.001,
}


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "metrics").glob("*.py")))
def test_reader_on_fake_trace(name):
    v = run.load_reader(name)(fake_ctx())
    assert v is not None and v > 0
    if name in EXPECTED:
        assert v == pytest.approx(EXPECTED[name])
    if name.endswith("_roofline") or name == "mfu":
        assert v <= 100.0 or name != "mfu"


def test_k2_and_mfu_arithmetic():
    ctx = fake_ctx()
    b = roofline.k2_bound([(0, [90, 91]), (1, [95, 96])], 28, 4, 128)
    assert run.load_reader("k2_roofline")(ctx) == pytest.approx(100 * b / 0.001)
    flops = (2.0 * roofline.llm_linear_params(CONF["dims"]["llm"]) * 4
             + 4.0 * 28 * 128 * (90 + 91 + 95 + 96)
             + 2 * (roofline.encoder_flops(CONF["dims"]["encoder"], 32)
                    + roofline.adapter_flops(CONF["dims"]["adapter"], 7)))
    assert run.load_reader("mfu")(ctx) == pytest.approx(100 * flops / (0.010 * 989e12))
    assert roofline.llm_linear_params(CONF["dims"]["llm"]) == 6_525_288_448


@pytest.mark.parametrize("name", ["k1_roofline", "k5_roofline", "k2_roofline", "mfu",
                                  "device_idle.overload", "step_ms.overload",
                                  "decision_p95_ms"])
def test_reader_finds_nothing(name):
    ctx = fake_ctx()
    ctx.update(trace=None, launches=None, spans={"step": [], "frontend": [],
                                                  "dispatch": []})
    ctx["win"]["latencies"] = []
    assert run.load_reader(name)(ctx) is None


def test_short_line_is_refused():
    """A traced run whose trace held no K1 kernel (the fault of a light
    window) stops with an error naming the metric; no line is printed."""
    ctx = fake_ctx()
    ctx["trace"] = trace.summarize([(K2, 0.001, 0.002)], [], 0.0, 0.01)
    cell = "int8.listen-overload"
    declared = run.cell_metrics(DOC, cell, "per_layer")
    assert "k1_roofline" in [m["name"] for m in declared]
    with pytest.raises(SystemExit, match="k1_roofline"):
        run.read_metrics(declared, ctx)


def test_every_declared_metric_present_on_full_trace():
    for cell in DOC["workloads"]:
        for kind in ("end_to_end", "per_layer"):
            got = run.read_metrics(run.cell_metrics(DOC, cell["name"], kind),
                                   fake_ctx())
            assert got and all(v["value"] > 0 for v in got.values())
