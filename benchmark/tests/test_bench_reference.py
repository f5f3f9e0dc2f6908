"""The harness, end to end on the CPU at test widths: the port served and
judged against the plain reference, which must agree with it; the timed
path broken underneath (the faults a serving cell can have), which must
come out not correct; and the lower-precision control, which must too.
The full-size readings behind the limits come from the chip (PERF.md)."""

import json
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness, judge, run, traffic

DATA = Path(__file__).resolve().parent / "data"


def conf(name):
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


def serve(cname, mname, seed, control=False):
    """A window of a fixed count of steps, so a loaded machine serves the
    same work."""
    c = conf(cname)
    out = harness.execute({"name": "test", "kernels": []}, c,
                          traffic.load_mix(mname, DATA), seed, 0.0, False,
                          "cpu", control=control, steps=60)
    checks = judge.checks_of(out["numbers"], c["limits"])
    return out, checks, judge.passed(checks) and out["numbers"]["drained"]


@pytest.mark.parametrize("cname,mname,seed", [
    ("tiny-int8", "tiny-ahead", 2**31 + 12345),
    ("tiny-int4", "tiny-open", 987654321)])
def test_port_agrees_with_reference(cname, mname, seed):
    out, checks, ok = serve(cname, mname, seed)
    assert ok, checks
    assert checks["compared"]["value"] >= conf(cname)["limits"]["min_compared"]
    assert out["win"]["attempted"] > 0 and out["win"]["failed"] == 0
    if mname == "tiny-ahead":
        assert out["win"]["stream_rate"] > 0
    else:
        assert out["win"]["latencies"]


def _state_unchanged(mp):
    """Every LLM step runs on a copy of the cache: the served state never
    advances."""
    from freeze_omni_tpu_torch.models import qwen2

    real = qwen2.forward

    def forward(params, cfg, embeds, mask, cache, *a, **k):
        return real(params, cfg, embeds, mask, qwen2.copy_cache(cache), *a, **k)[0], cache

    mp.setattr(qwen2, "forward", forward)


def _half_batch(mp):
    """Every other pending session's chunk is left out of the tick."""
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine

    real = ServingEngine._gather_pending

    def gather(self, identity):
        out = real(self, identity)
        if out is None:
            return None
        pending, chunks, active, is_sl = out
        for n, slot in enumerate(sorted(pending)):
            if n % 2:
                pending.pop(slot)
                active[slot] = False
        return pending, chunks, active, is_sl

    mp.setattr(ServingEngine, "_gather_pending", gather)


def _answer_altered(mp):
    """The state head's answer altered where it is produced."""
    from freeze_omni_tpu_torch.models import audio_llm

    real = audio_llm.state_head
    mp.setattr(audio_llm, "state_head",
               lambda params, h: real(params, h).roll(1, dims=-1))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, checks, ok = serve("tiny-int8", "tiny-ahead", 4242)
    assert not ok, checks


@pytest.mark.parametrize("cname,mname", [("tiny-int8", "tiny-ahead"),
                                         ("tiny-int4", "tiny-ahead")])
def test_control_is_not_correct(cname, mname):
    """The control in the program's place: the frontend in bfloat16, and
    the int8 configuration served through the int4 path (the int4 one's
    reference with grouped int3 weights)."""
    _, checks, ok = serve(cname, mname, 31337, control=True)
    assert not ok, checks
    lim = conf(cname)["limits"]
    assert checks["fbank_gap"]["value"] > lim["fbank_gap"]
    assert checks["vad_prob_gap"]["value"] > lim["vad_prob_gap"]
    assert checks["state_gap"]["value"] > lim["state_gap"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "int8.listen-overload", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "freeze_omni_tpu_torch_fake",
                        types.ModuleType("freeze_omni_tpu_torch_fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert run.forbidden_modules() == ["jaxlib"]


def test_same_seed_same_traffic():
    mix = traffic.load_mix("listen-overload")
    mix = dict(mix, clip_bank=2, call_pool=2)
    a, b = traffic.Traffic(mix, 2**33 + 7), traffic.Traffic(mix, 2**33 + 7)
    ca, cb = a.call(3, 1), b.call(3, 1)
    assert ca.message("user", 5) == cb.message("user", 5)
    assert ca.message("system", 9) == cb.message("system", 9)
    assert 16 / 0.224 - 1 <= ca.n_msgs <= 28 / 0.224 + 1
