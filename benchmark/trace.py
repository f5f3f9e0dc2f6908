"""Reduction of a torch.profiler trace (device activity only) to what the
per-layer readers take: the traced window, the device operations in it,
the device's busy time, and the benchmark's own host spans ('bench.*',
marked with time.time_ns on the clock kineto aligns device events to),
all in seconds from the window's start."""

from __future__ import annotations

from typing import List, Tuple


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device operation of a finished
    profile, on the host's clock (time.time_ns), as kineto aligns them.
    The GPU-side copies of host annotations are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()) or e.name().startswith("bench."):
            continue
        s = int(e.start_ns())
        out.append((e.name(), s, s + int(e.duration_ns())))
    return out


def reduce(prof, host_marks: List[Tuple[str, int]], w0: int, w1: int) -> dict:
    """The traced window [w0, w1] (time.time_ns), its device operations and
    the host spans between the benchmark's marks, in seconds from w0."""
    sec = lambda t: (t - w0) * 1e-9  # noqa: E731
    device = sorted(((n, sec(max(s, w0)), sec(min(e, w1)))
                     for n, s, e in device_events(prof) if e > w0 and s < w1),
                    key=lambda x: x[1])
    host = []
    for (name, t), (_, t_next) in zip(host_marks, host_marks[1:] + [(None, w1)]):
        if name is not None:
            host.append((name, sec(t), sec(t_next)))
    return summarize(device, host, 0.0, sec(w1))


def summarize(device: List[Tuple[str, float, float]],
              host: List[Tuple[str, float, float]], w0: float, w1: float) -> dict:
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    last_end = w0
    for _, s, e in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    return {"window_s": w1 - w0, "busy_s": busy, "device": device,
            "host": host, "gaps": gaps}


def host_span_at(host, t: float) -> str:
    """The benchmark span open on the host at time t."""
    label = "bench.none"
    for n, s, e in host:
        if s <= t < e:
            label = n
        elif s > t:
            break
    return label


def breakdown(tr: dict, top: int = 10) -> dict:
    by_name: dict = {}
    for n, s, e in tr["device"]:
        key = n if len(n) <= 120 else n[:117] + "..."
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    gaps = sorted(tr["gaps"], key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[host_span_at(tr["host"], s), e - s] for s, e in gaps]}
