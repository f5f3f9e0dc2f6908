"""Timers and the roofline bound of the card's measurement scripts
(chip_smoke.py, bin/k2_profile.py, bin/k4_profile.py, bin/k5_profile.py).
The timers need a CUDA card."""

from __future__ import annotations

import torch

from freeze_omni_tpu_torch.ops import _build

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak


def bound(nbytes, nops):
    """The least time in ms for work that moves `nbytes` and does `nops`
    bf16 operations, and which of the two bounds it ("bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_time_ms(fn, iters=50, warmup=5):
    """Eager time of one call of fn: CUDA events around `iters`
    back-to-back calls, host time per call included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls=20, replays=10):
    """Device time of one call of fn: `calls` calls captured in one CUDA
    graph (after warm-up calls on the capture stream) and replayed, timed
    with CUDA events. Unlike cuda_time_ms this leaves out the host's time
    per call, which bounds eager back-to-back calls of the narrow shapes."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    _build.release_workspace(torch.cuda.current_device(), stream.cuda_stream)
    return start.elapsed_time(end) / (replays * calls)


def kernel_times_ms(fn, reps=20):
    """Device time per call of each kernel fn launches, by torch.profiler:
    {kernel name without namespace, template arguments or signature: ms}.
    Run it after the other timers: the profiler's tracing may stay attached
    to the launches that follow it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t:
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out
