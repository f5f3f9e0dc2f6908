"""Spans and counters of the serving tick, and the per-stage latency spans of
the offline CLI (counterpart of freeze_omni_tpu/utils/logging.py).

The reference's tracing is a print monkey-patch with millisecond timestamps
(bin/dialog_state_pred.py:52-59). Here the serving path records, per
service step, one record:

- `step`: the service's step index, shared by every span of the tick;
- `spans`: interval spans (name, parent, t0_ns, t1_ns), nested as opened;
- `stages`: per-session stages summed over the step (name, parent,
  total_ns, calls), so that a record's size does not grow with the
  session count;
- `counters`: the step's integer counters;
- `attrs`: the step's attributes (sessions).

The tracer is off by default. A hot-path site reads the flag once and
branches, so that off it costs one module attribute read and a branch (no
clock read, no allocation):

    on = trace.ON
    if on:
        trace.begin("engine.h2d")
    ...
    if on:
        trace.end()

`enable(True, steps=n)` turns it on; records then live in a ring of the
last n steps and `snapshot()` returns them as plain Python data. Times are
`time.time_ns()`, the host clock to which kineto aligns a torch.profiler's
device events, so the spans sit on the device timeline's axis. The tracer
reads no device value: every count is known on the host.

One serving loop per process: the open step and its stack of open spans
are module state. `span` / `span_stats` / `span_report` / `reset_spans`
keep the registry API of the offline CLI: a `span` records whether or not
the tracer is on (it times coarse one-off stages, not the serving hot
path), as a record of its own in the same ring.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ON = False
DEFAULT_STEPS = 4096

_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_STEPS)
_cur: Optional["_Record"] = None
_stack: List[int] = []          # the open step's open spans, by index
_legacy = threading.local()     # names of the open `span`s of this thread


class _Record:
    __slots__ = ("step", "attrs", "spans", "stages", "counters")

    def __init__(self, step):
        self.step = step
        self.attrs: Dict[str, int] = {}
        self.spans: List[tuple] = []
        self.stages: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}

    def plain(self) -> dict:
        return {"step": self.step, "attrs": dict(self.attrs),
                "spans": list(self.spans),
                "stages": [(n, p, t, c) for n, (p, t, c) in self.stages.items()],
                "counters": dict(self.counters)}


def enable(on: bool = True, steps: Optional[int] = None) -> None:
    """Turn the tracer on or off; `steps` sets the ring's length (the
    newest records are kept)."""
    global ON, _ring
    with _lock:
        if steps is not None and steps != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, int(steps)))
    ON = bool(on)


def now() -> int:
    return time.time_ns()


# ---- the step's record (called only where ON was read true) -------------

def step_begin(step: int) -> None:
    """Open the record of one service step and its root span
    `service.step`."""
    global _cur
    t = time.time_ns()
    _cur = _Record(step)
    _cur.spans.append(("service.step", None, t, -1))
    _stack[:] = [0]


def step_end(**attrs) -> None:
    """Close the root and the spans still open (they run to the step's
    end), and keep the record in the ring."""
    global _cur
    rec = _cur
    if rec is None:
        return
    t = time.time_ns()
    for i in _stack:
        name, parent, t0, _ = rec.spans[i]
        rec.spans[i] = (name, parent, t0, t)
    del _stack[:]
    rec.attrs.update(attrs)
    _cur = None
    with _lock:
        _ring.append(rec)


def begin(name: str) -> None:
    """Open an interval span inside the open step."""
    rec = _cur
    if rec is not None:
        parent = rec.spans[_stack[-1]][0] if _stack else None
        _stack.append(len(rec.spans))
        rec.spans.append((name, parent, time.time_ns(), -1))


def end() -> None:
    """Close the innermost open span (never the root)."""
    rec = _cur
    if rec is not None and len(_stack) > 1:
        i = _stack.pop()
        name, parent, t0, _ = rec.spans[i]
        rec.spans[i] = (name, parent, t0, time.time_ns())


def stage(name: str, t0: int) -> int:
    """Add the time since t0 to the step's summed stage `name` (its parent
    the innermost open span); returns now, the next stage's start."""
    t = time.time_ns()
    rec = _cur
    if rec is not None:
        s = rec.stages.get(name)
        if s is None:
            rec.stages[name] = [rec.spans[_stack[-1]][0] if _stack else None,
                                t - t0, 1]
        else:
            s[1] += t - t0
            s[2] += 1
    return t


def count(name: str, n: int = 1) -> None:
    rec = _cur
    if rec is not None:
        c = rec.counters
        c[name] = c.get(name, 0) + int(n)


def peak(name: str, v: int) -> None:
    """Counter `name` (named `*.max`) holds the largest value seen in the
    step."""
    rec = _cur
    if rec is not None:
        c = rec.counters
        if v > c.get(name, -1):
            c[name] = int(v)


# ---- reading --------------------------------------------------------------

def snapshot(last: Optional[int] = None) -> List[dict]:
    """The ring's records, oldest first (the last `last` of them), as plain
    Python data."""
    with _lock:
        recs = list(_ring)
    if last is not None:
        recs = recs[-last:] if last > 0 else []
    return [r.plain() for r in recs]


def reset() -> None:
    with _lock:
        _ring.clear()


def summary(records: List[dict]) -> dict:
    """Per-step means over the service steps of `records`: each interval
    span's and each summed stage's time (ms, a step without it counts 0),
    a stage's calls, and every counter's total (the largest value of a
    `peak` counter, named `*.max`)."""
    steps = [r for r in records if r["step"] is not None]
    n = len(steps)
    spans: Dict[str, float] = {}
    stages: Dict[str, list] = {}
    counters: Dict[str, int] = {}
    for r in steps:
        for name, _, t0, t1 in r["spans"]:
            spans[name] = spans.get(name, 0) + (t1 - t0)
        for name, _, total, calls in r["stages"]:
            s = stages.setdefault(name, [0, 0])
            s[0] += total
            s[1] += calls
        for name, v in r["counters"].items():
            if name.endswith(".max"):
                counters[name] = max(counters.get(name, v), v)
            else:
                counters[name] = counters.get(name, 0) + v
    return {"steps": n,
            "first_step": steps[0]["step"] if n else None,
            "last_step": steps[-1]["step"] if n else None,
            "spans_ms": {k: v * 1e-6 / n for k, v in spans.items()},
            "stages_ms": {k: v[0] * 1e-6 / n for k, v in stages.items()},
            "stage_calls": {k: v[1] / n for k, v in stages.items()},
            "counters": counters}


# ---- the offline CLI's registry -------------------------------------------

@contextlib.contextmanager
def span(name: str):
    """Time a block; kept as an interval span of a record of its own
    (step None), its parent the enclosing `span` of this thread."""
    stack = getattr(_legacy, "stack", None)
    if stack is None:
        stack = _legacy.stack = []
    parent = stack[-1] if stack else None
    stack.append(name)
    t0 = time.time_ns()
    try:
        yield
    finally:
        t1 = time.time_ns()
        stack.pop()
        rec = _Record(None)
        rec.spans.append((name, parent, t0, t1))
        with _lock:
            _ring.append(rec)


def span_stats() -> Dict[str, dict]:
    """Per span name over the ring: count, total, mean, p50, p90 (ms)."""
    xs: Dict[str, List[int]] = {}
    for r in snapshot():
        for name, _, t0, t1 in r["spans"]:
            xs.setdefault(name, []).append(t1 - t0)
    out = {}
    for name, v in xs.items():
        s = sorted(v)
        out[name] = {
            "count": len(s),
            "total_ms": sum(s) * 1e-6,
            "avg_ms": sum(s) / len(s) * 1e-6,
            "p50_ms": s[len(s) // 2] * 1e-6,
            "p90_ms": s[min(len(s) - 1, int(len(s) * 0.9))] * 1e-6,
        }
    return out


def span_report() -> str:
    lines = ["-- latency spans --"]
    for name, st in span_stats().items():
        lines.append(
            f"{name:>16}: n={st['count']:<4} avg={st['avg_ms']:8.1f}ms "
            f"p50={st['p50_ms']:8.1f}ms p90={st['p90_ms']:8.1f}ms"
        )
    return "\n".join(lines)


def reset_spans() -> None:
    reset()
