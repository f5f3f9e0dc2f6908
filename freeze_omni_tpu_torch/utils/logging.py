"""Structured per-stage latency spans (counterpart of
freeze_omni_tpu/utils/logging.py).

The reference's tracing is a print monkey-patch with millisecond timestamps
(bin/dialog_state_pred.py:52-59). Here spans accumulate into a registry so
a per-stage latency breakdown can be reported; `device_span` also names the
region in a `torch.profiler` trace, so host spans line up with the device
timeline. Spans time the host: a region that queues device work and does
not synchronize measures the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

_SPANS: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SPANS[name].append(time.perf_counter() - t0)


def span_stats() -> Dict[str, dict]:
    out = {}
    for name, xs in _SPANS.items():
        s = sorted(xs)
        out[name] = {
            "count": len(s),
            "total_ms": sum(s) * 1e3,
            "avg_ms": sum(s) / len(s) * 1e3,
            "p50_ms": s[len(s) // 2] * 1e3,
            "p90_ms": s[min(len(s) - 1, int(len(s) * 0.9))] * 1e3,
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
    _SPANS.clear()


@contextlib.contextmanager
def device_span(name: str):
    """A span that also annotates a `torch.profiler` capture."""
    import torch

    with torch.profiler.record_function(name):
        with span(name):
            yield
