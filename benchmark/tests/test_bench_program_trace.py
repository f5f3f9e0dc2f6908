"""benchmark/program_trace.py: the device's idle time cut by the port's
spans on synthetic intervals, the readings of its records on synthetic
steps, and a run at test widths on the CPU with the port's tracer on."""

import json
from pathlib import Path

import pytest

from benchmark import program_trace as pt
from benchmark import trace, traffic

DATA = Path(__file__).resolve().parent / "data"
MS = 1_000_000          # ns
W0 = 1_700_000_000 * 10**9


def rec(step, t, spans, stages=(), **counters):
    """A step record at `t` ms from W0: spans (name, parent, t0, t1) in ms."""
    ns = lambda x: W0 + int(round((t + x) * MS))  # noqa: E731
    return {"step": step, "attrs": {"sessions": 2},
            "spans": [(n, p, ns(a), ns(b)) for n, p, a, b in spans],
            "stages": [(n, "service.frontend", int(v * MS), c) for n, v, c in stages],
            "counters": dict(counters)}


def tick(step, t, frontend=3.0, submit=2.0, deliver=1.0, decide=0.5, **counters):
    """A ticking step: frontend, submit (h2d and launch inside), deliver,
    decide, back to back, 0.1 ms apart."""
    a = frontend
    b = a + 0.1 + submit
    c = b + 0.1 + deliver
    d = c + 0.1 + decide
    spans = [("service.step", None, 0.0, d),
             ("service.frontend", "service.step", 0.0, a),
             ("engine.submit", "service.step", a + 0.1, b),
             ("engine.h2d", "engine.submit", a + 0.2, a + 0.6),
             ("engine.launch", "engine.submit", a + 0.6, b),
             ("engine.deliver", "service.step", b + 0.1, c),
             ("service.decide", "service.step", c + 0.1, d)]
    counters.setdefault("engine.rows_active.user", 2)
    return rec(step, t, spans, [("frontend.vad", 1.0, 4), ("frontend.gate", 0.5, 4)],
               **counters)


def window():
    """Two ticking steps 10 ms apart from t = 1 ms, and device work that
    leaves gaps across the host's spans, in a 25 ms window."""
    recs = [tick(1, 1.0, **{"engine.tokens_valid": 10, "engine.tokens_computed": 24}),
            tick(2, 11.0, **{"engine.tokens_valid": 14, "engine.tokens_computed": 24})]
    device = [("k", 0.0, 0.0005), ("k", 0.0045, 0.0060), ("k", 0.0090, 0.0125),
              ("k", 0.0140, 0.0160), ("k", 0.0185, 0.0200)]
    tr = trace.summarize(device, [], 0.0, 0.025)
    return recs, tr


def test_idle_classes_partition_the_idle_time():
    recs, tr = window()
    bd = pt.breakdown_program(tr, recs, W0)
    idle = 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
    assert sum(bd["idle_share"].values()) == pytest.approx(idle, abs=1e-9)
    assert sum(bd["idle_s"].values()) == pytest.approx(sum(b - a for a, b in tr["gaps"]))
    # gap 0.5-4.5 ms: outside to 1.0, then the first step's frontend (1.0-4.0),
    # the 0.1 ms between tiles (service.step) and its submit from 4.1
    one = pt.idle_by_class([(0.0005, 0.0045)], pt.tiles(recs, W0))
    assert one["outside"] == pytest.approx(0.0005)
    assert one["service.frontend"] == pytest.approx(0.003)
    assert one["service.step"] == pytest.approx(0.0001)
    assert one["engine.submit"] == pytest.approx(0.0004)
    assert sum(one.values()) == pytest.approx(0.004)


def test_longest_gaps_are_labelled_by_the_port():
    recs, tr = window()
    bd = pt.breakdown_program(tr, recs, W0, top=5)
    got = [[g[0], g[1], round(g[2], 6)] for g in bd["gaps"]]
    assert got == [["outside", "outside", 0.005],            # after the last step
                   ["outside", "service.frontend", 0.004],   # before the first
                   ["engine.launch", "outside", 0.003],      # launch to between steps
                   ["engine.launch", "engine.deliver", 0.0025],
                   ["service.frontend", "service.frontend", 0.0015]]
    assert pt.innermost_at(recs, W0, 0.0045) == "engine.h2d"


def test_readings_of_synthetic_steps():
    recs, tr = window()
    got = pt.readings({"window": recs, "traced": recs, "w0_ns": W0}, tr)
    assert got["vad_ms"] == pytest.approx(1.0)
    assert got["gate_ms"] == pytest.approx(0.5)
    assert got["h2d_ms"] == pytest.approx(0.4)
    assert got["launch_ms"] == pytest.approx(1.5)
    assert got["pad_share"] == pytest.approx(100.0 * (1 - 24 / 48))
    share = pt.breakdown_program(tr, recs, W0)["idle_share"]
    assert got["idle_frontend"] == share["service.frontend"] > 0
    assert got["idle_submit"] == share["engine.submit"] > 0
    assert got["idle_outside"] == share["outside"] > 0
    for key, v in got.items():
        assert v is not None and v >= 0, key


def test_readings_are_zero_where_the_quantity_is():
    """A stage no ticking step ran reads 0.0, as does a pad share with no
    padding and an idle share of a device that never idles in the class."""
    recs = [rec(1, 0.0, [("service.step", None, 0.0, 5.0),
                         ("service.frontend", "service.step", 0.0, 5.0)],
                **{"engine.rows_active.user": 1, "engine.tokens_valid": 12,
                   "engine.tokens_computed": 12})]
    tr = trace.summarize([("k", 0.0, 0.005)], [], 0.0, 0.005)
    got = pt.readings({"window": recs, "traced": recs, "w0_ns": W0}, tr)
    for key in ("vad_ms", "gate_ms", "h2d_ms", "launch_ms", "pad_share",
                "idle_frontend", "idle_submit", "idle_outside"):
        assert got[key] == 0.0, key


def test_readings_find_nothing_without_their_source():
    got = pt.readings({"window": [], "traced": [], "w0_ns": None}, None)
    assert all(v is None for v in got.values())


def test_a_run_at_test_widths_with_the_tracer():
    """The port's spans of the harness's own steps agree with its outside
    spans, and the profiled ticks' tokens with its pass-through wrappers."""
    conf = json.loads((DATA / "configs" / "tiny-int8.json").read_text())
    mix = traffic.load_mix("tiny-ahead", DATA)
    out = pt.execute({"name": "test", "kernels": []}, conf, mix, 2**31 + 77, 0.0,
                     True, "cpu", log=lambda *a: None, steps=30)
    prog = out["program"]
    assert out["numbers"]["drained"] and out["numbers"]["submit_mismatch"] == 0
    agree = pt.agreement(prog, out["spans"], out["launches"])
    assert agree["ticking_steps"][0] == agree["ticking_steps"][1] == out["steps"] > 0
    tokens = agree["tokens_valid"]
    assert tokens[0] == tokens[1] > 0
    for key in ("step", "frontend", "dispatch"):
        inside, outside, rel = agree[key]
        assert inside > 0 and abs(rel) < 0.05, (key, agree[key])
    got = pt.readings(prog, out["trace"])
    assert got["launch_ms"] > 0 and 0 < got["pad_share"] < 100
    assert prog["traced"] and len(prog["traced"]) >= mix["trace_steps"]


def test_ab_runs_every_other_step_with_the_tracer():
    conf = json.loads((DATA / "configs" / "tiny-int8.json").read_text())
    mix = traffic.load_mix("tiny-ahead", DATA)
    out = pt.execute({"name": "test", "kernels": []}, conf, mix, 99, 0.0,
                     False, "cpu", tracer="ab", log=lambda *a: None, steps=24)
    ab = out["ab"]
    assert abs(ab["steps"][0] - ab["steps"][1]) <= 1 and ab["steps"][0] > 0
    assert ab["on_ms"] > 0 and ab["off_ms"] > 0 and ab["on_cost_se"] > 0
    from freeze_omni_tpu_torch.utils import logging as ptrace

    assert not ptrace.ON


def test_ab_on_cost_against_the_neighbours():
    """A host that slows down step by step: the neighbours' mean takes the
    drift out, the means of the two halves do not."""
    seen = [(i % 2 == 1, 0.100 + 0.001 * i + (0.002 if i % 2 else 0.0), True)
            for i in range(11)]
    ab = pt.ab_summary(seen)
    assert ab["steps"] == [5, 6]
    assert ab["on_cost"] == pytest.approx(0.002 / (1e-3 * ab["off_ms"]))
    assert ab["on_cost_se"] == pytest.approx(0.0, abs=1e-12)
