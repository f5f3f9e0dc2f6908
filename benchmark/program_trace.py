"""A cell's run read through the port's own spans and counters
(freeze_omni_tpu_torch/utils/logging): where the card's idle time goes, by
the stage of the port the host was in.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> [--tracer on|ab] [--trace 0|1]

runs the cell as `benchmark/run.py` does (the same harness, traffic,
judge and result line), with the port's tracer on from the start of
set-up (`--tracer on`), or on in every other step of the window (`ab`:
the tracer's on-cost, both halves on one host in one run). It prints the benchmark's result line with these keys added:

- `program`: the per-layer readings of the port's spans and counters over
  the window's ticking steps (`vad_ms`, `gate_ms`, `h2d_ms`,
  `launch_ms`, `pad_share`), and, traced, the idle shares
  (`idle_frontend`, `idle_submit`, `idle_outside`);
- `breakdown_program` (traced): every device idle interval of the profiled
  window cut by the port's top-level spans open on the host
  (`service.frontend`, `engine.submit`, `engine.deliver`,
  `service.decide`; `service.step` for the step's time between them;
  `outside` where no port span is open: the harness's feed and the Python
  between calls), each class's seconds and share of the window (the
  shares sum to `device_idle`), and the five longest gaps labelled by the
  innermost port span at their start and the class they overlap most;
- `agree`: the port's spans against the harness's outside spans of the
  same steps (`step_ms`, `frontend_ms`, `dispatch_ms`) and the profiled
  ticks' valid tokens against the pass-through wrappers' count;
- `stages_ms` / `traced_stages_ms`: `utils/logging.summary` of the
  window's / the profiled ticking steps (every span, stage and counter);
- `stream_rate` and `spans_ms`: the window's rate and the harness's outside
  spans (ms) of its ticking steps;
- `ab` (`--tracer ab`): the mean ticking step with the tracer on and off,
  and the on-cost of each traced step against its untraced neighbours.

The benchmark's command does not turn the tracer on, so its lines carry
none of this; PERF.md says what the harness would need.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

TOP = ("service.frontend", "engine.submit", "engine.deliver", "service.decide")
CLASSES = TOP + ("service.step", "outside")


# --------------------------------------------------------------------------
# reading the port's records
# --------------------------------------------------------------------------

def ticking(rec: dict) -> bool:
    """A step whose tick ran rows (the harness's ticking step)."""
    c = rec["counters"]
    return bool(c.get("engine.rows_active.user") or c.get("engine.rows_active.system"))


def stage_ms(rec: dict, name: str) -> float:
    """A step's time in interval spans or summed stages named `name`, ms
    (0 where it has none)."""
    ns = sum(t1 - t0 for n, _, t0, t1 in rec["spans"] if n == name)
    ns += sum(total for n, _, total, _ in rec["stages"] if n == name)
    return ns * 1e-6


def mean_ms(records: List[dict], name: str) -> Optional[float]:
    """Mean of `name` over the ticking steps of `records`, ms."""
    ticks = [r for r in records if ticking(r)]
    return sum(stage_ms(r, name) for r in ticks) / len(ticks) if ticks else None


def pad_share(records: List[dict]) -> Optional[float]:
    """Share of the tokens the forwards computed that no row needed, %."""
    valid = sum(r["counters"].get("engine.tokens_valid", 0) for r in records)
    done = sum(r["counters"].get("engine.tokens_computed", 0) for r in records)
    return 100.0 * (1.0 - valid / done) if done else None


# --------------------------------------------------------------------------
# the device's idle time by the port's stage
# --------------------------------------------------------------------------

def tiles(records: List[dict], w0_ns: int) -> List[tuple]:
    """(step start, step end, [(class, start, end), ...]) of every step, in
    seconds from w0: the step's top-level spans in order."""
    out = []
    for r in records:
        root = next(s for s in r["spans"] if s[0] == "service.step")
        sec = lambda t: (t - w0_ns) * 1e-9  # noqa: E731
        kids = sorted((n, sec(t0), sec(t1)) for n, p, t0, t1 in r["spans"]
                      if p == "service.step" and n in TOP)
        out.append((sec(root[2]), sec(root[3]), sorted(kids, key=lambda k: k[1])))
    return sorted(out, key=lambda x: x[0])


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def idle_by_class(gaps: List[tuple], steps: List[tuple]) -> Dict[str, float]:
    """Seconds of the device's idle gaps (start, end) in each class: the
    top-level span of the step the host was in, `service.step` where it
    was in a step between them, `outside` where it was in no step."""
    out = {c: 0.0 for c in CLASSES}
    for a, b in gaps:
        in_steps = 0.0
        for s0, s1, kids in steps:
            o = _overlap(a, b, s0, s1)
            if o <= 0.0:
                continue
            in_steps += o
            in_kids = 0.0
            for name, k0, k1 in kids:
                ok = _overlap(a, b, k0, k1)
                out[name] += ok
                in_kids += ok
            out["service.step"] += o - in_kids
        out["outside"] += (b - a) - in_steps
    return out


def innermost_at(records: List[dict], w0_ns: int, t: float) -> str:
    """The innermost port span (any name) open on the host at t seconds
    from w0: the latest opened of those that hold t."""
    best, best_t0 = "outside", None
    tn = w0_ns + t * 1e9
    for r in records:
        for name, _, t0, t1 in r["spans"]:
            if t0 <= tn < t1 and (best_t0 is None or t0 >= best_t0):
                best, best_t0 = name, t0
    return best


def breakdown_program(tr: dict, records: List[dict], w0_ns: int, top: int = 5) -> dict:
    """The device's idle time of a traced window (trace.summarize's) by the
    port's stage: seconds and share of the window (%) of each class, and
    the `top` longest gaps as [innermost span at the start, class of the
    largest overlap, seconds]."""
    steps = tiles(records, w0_ns)
    by = idle_by_class(tr["gaps"], steps)
    w = tr["window_s"]
    longest = []
    for a, b in sorted(tr["gaps"], key=lambda g: g[0] - g[1])[:top]:
        one = idle_by_class([(a, b)], steps)
        longest.append([innermost_at(records, w0_ns, a),
                        max(one, key=lambda c: one[c]), b - a])
    return {"idle_s": by,
            "idle_share": {c: 100.0 * v / w for c, v in by.items()} if w > 0 else {},
            "gaps": longest}


# --------------------------------------------------------------------------
# the readings of a run
# --------------------------------------------------------------------------

def readings(prog: dict, tr: Optional[dict]) -> dict:
    """prog: {"window": records, "traced": records, "w0_ns": int or None}.
    The per-layer readings of the port's records, None where their
    source holds nothing (the idle shares need a device trace)."""
    win = prog["window"]
    out = {"vad_ms": mean_ms(win, "frontend.vad"),
           "gate_ms": mean_ms(win, "frontend.gate"),
           "h2d_ms": mean_ms(win, "engine.h2d"),
           "launch_ms": mean_ms(win, "engine.launch"),
           "pad_share": pad_share(win)}
    idle = {"idle_frontend": "service.frontend", "idle_submit": "engine.submit",
            "idle_outside": "outside"}
    share = None
    if tr is not None and prog.get("w0_ns") is not None and tr["window_s"] > 0:
        share = breakdown_program(tr, prog["traced"], prog["w0_ns"])["idle_share"]
    for key, cls in idle.items():
        out[key] = share[cls] if share is not None else None
    return out


def agreement(prog: dict, spans: dict, launches: Optional[dict]) -> dict:
    """[inside, outside, inside / outside - 1] of the step, frontend and
    dispatch means over the window's ticking steps (ms), and [program,
    wrappers] of the profiled ticks' valid tokens."""
    import numpy as np

    win = prog["window"]
    out = {}
    for key, inside in (("step", ["service.step"]), ("frontend", ["service.frontend"]),
                        ("dispatch", ["engine.submit", "engine.deliver"])):
        xs = spans.get(key)
        if xs and any(ticking(r) for r in win):
            i, o = sum(mean_ms(win, n) for n in inside), 1e3 * float(np.mean(xs))
            out[key] = [i, o, i / o - 1.0]
    out["ticking_steps"] = [sum(ticking(r) for r in win), len(spans.get("step") or [])]
    if launches is not None:
        out["tokens_valid"] = [
            sum(r["counters"].get("engine.tokens_valid", 0) for r in prog["traced"]),
            sum(f["valid"] for f in launches["forwards"])]
    return out


# --------------------------------------------------------------------------
# a run with the port's tracer
# --------------------------------------------------------------------------

class Capture:
    """Time marks of a harness.execute run, taken by wrapping the harness's
    own calls (nothing of it is edited): the measured window (the two
    host_state readings around it), the profiled ticks (the last
    _profiled call) and the traced window's start (trace.reduce's w0)."""

    def __init__(self):
        self.host_marks: List[tuple] = []
        self.profiled: Optional[tuple] = None
        self.w0_ns: Optional[int] = None
        self._undo = []

    def install(self):
        from benchmark import harness, trace

        cap = self

        def patch(mod, name, make):
            real = getattr(mod, name)
            setattr(mod, name, make(real))
            self._undo.append((mod, name, real))

        def host_state(real):
            def f():
                t0 = time.time_ns()
                out = real()
                cap.host_marks.append((t0, time.time_ns()))
                return out
            return f

        def profiled(real):
            def f(*a, **k):
                t0 = time.time_ns()
                out = real(*a, **k)
                cap.profiled = (t0, time.time_ns())
                return out
            return f

        def reduce(real):
            def f(prof, host_marks, w0, w1):
                cap.w0_ns = int(w0)
                return real(prof, host_marks, w0, w1)
            return f

        patch(harness, "host_state", host_state)
        patch(harness, "_profiled", profiled)
        patch(trace, "reduce", reduce)

    def remove(self):
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)
        self._undo = []

    def split(self, records: List[dict]) -> dict:
        """The records of the measured window and of the profiled ticks."""
        steps = [r for r in records if r["step"] is not None]

        def within(t0, t1):
            out = []
            for r in steps:
                root = next(s for s in r["spans"] if s[0] == "service.step")
                if t0 <= root[2] and root[3] <= t1:
                    out.append(r)
            return out

        win = within(self.host_marks[0][1], self.host_marks[1][0]) \
            if len(self.host_marks) >= 2 else []
        traced = within(*self.profiled) if self.profiled else []
        return {"window": win, "traced": traced, "w0_ns": self.w0_ns}


def ab_steps(seed: int):
    """Wrap harness.Run.step so the window's steps run with the tracer on
    and off in turn (the seed picks which first); returns the list of (on,
    seconds, ticked) of the window's steps and the undo."""
    from benchmark import harness
    from freeze_omni_tpu_torch.utils import logging as ptrace

    real = harness.Run.step
    first = random.Random(seed).random() < 0.5
    seen: List[tuple] = []

    def step(self, span):
        if not span:
            return real(self, span)
        on = first == (len(seen) % 2 == 0)
        ptrace.enable(on)
        cur = real(self, span)
        ptrace.enable(False)
        seen.append((on, cur["end"] - cur["start"], cur["ticked"]))
        return cur

    harness.Run.step = step
    return seen, lambda: setattr(harness.Run, "step", real)


def ab_summary(seen: List[tuple]) -> dict:
    """The mean ticking step (ms) with the tracer on and off, and the
    on-cost from each traced step against the mean of its two untraced
    neighbours (which takes out the host's drift), with its standard
    error, both as shares of the untraced mean."""
    import numpy as np

    on = [s for o, s, t in seen if o and t]
    off = [s for o, s, t in seen if not o and t]
    if not on or not off:
        return {"steps": [len(on), len(off)]}
    m_off = float(np.mean(off))
    d = [seen[i][1] - 0.5 * (seen[i - 1][1] + seen[i + 1][1])
         for i in range(1, len(seen) - 1)
         if seen[i][0] and seen[i][2] and seen[i - 1][2] and seen[i + 1][2]]
    return {"on_ms": 1e3 * float(np.mean(on)), "off_ms": 1e3 * m_off,
            "steps": [len(on), len(off)],
            "on_cost": float(np.mean(d)) / m_off if d else None,
            "on_cost_se": float(np.std(d, ddof=1) / np.sqrt(len(d))) / m_off
            if len(d) > 1 else None}


def execute(spec: dict, conf: dict, mix: dict, seed: int, seconds: float,
            trace: bool, device, tracer: str = "on", log=print,
            steps: Optional[int] = None) -> dict:
    """harness.execute with the port's tracer as `tracer` says; the run's
    numbers plus "program" (the split records) or "ab"."""
    from benchmark import harness
    from freeze_omni_tpu_torch.utils import logging as ptrace

    cap = Capture()
    cap.install()
    undo_ab = None
    ptrace.reset()
    if tracer == "on":
        ptrace.enable(True, steps=1 << 16)
    elif tracer == "ab":
        seen, undo_ab = ab_steps(seed)
    try:
        out = harness.execute(spec, conf, mix, seed, seconds, trace, device,
                              log=log, steps=steps)
    finally:
        ptrace.enable(False)
        cap.remove()
        if undo_ab is not None:
            undo_ab()
    if tracer == "on":
        out["program"] = cap.split(ptrace.snapshot())
    if tracer == "ab":
        out["ab"] = ab_summary(seen)
    ptrace.reset()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=1, choices=[0, 1])
    p.add_argument("--tracer", default="on", choices=["on", "ab"])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    run.set_cache_env()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from benchmark.traffic import load_mix

    conf = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    spec = dict(cell)
    spec["kernels"] = [m["name"].split("_roofline")[0]
                       for m in run.cell_metrics(bench, cell["name"], "per_layer")
                       if m["name"].endswith("_roofline")] if args.trace else []
    out = execute(spec, conf, load_mix(cell["traffic"]), args.seed, args.seconds,
                  bool(args.trace), "cuda", tracer=args.tracer,
                  log=lambda *a: print(*a, file=sys.stderr))
    out["conf"] = conf
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(out["peak"])}
    line = run.result_line(bench, cell, out, bool(args.trace), device)
    line["stream_rate"] = out["win"]["stream_rate"]
    line["spans_ms"] = {k: 1e3 * sum(v) / len(v) if v else None
                        for k, v in out["spans"].items()}
    prog = out.get("program")
    if prog is not None:
        tr = out.get("trace")
        line["program"] = readings(prog, tr)
        line["agree"] = agreement(prog, out["spans"], out.get("launches"))
        line["stages_ms"] = _summary(prog["window"])
        if tr is not None and prog["w0_ns"] is not None:
            line["breakdown_program"] = breakdown_program(tr, prog["traced"],
                                                          prog["w0_ns"])
            line["traced_stages_ms"] = _summary(prog["traced"])
    if "ab" in out:
        line["ab"] = out["ab"]
    print(json.dumps(line), flush=True)
    return 0


def _summary(records: List[dict]) -> dict:
    """The port's summary over the ticking steps of `records`."""
    from freeze_omni_tpu_torch.utils import logging as ptrace

    return ptrace.summary([r for r in records if ticking(r)])


if __name__ == "__main__":
    sys.exit(main())
