"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (read from a fixed count of profiled
steps after the window) and a breakdown. Every run judges the served
decisions against the plain reference (benchmark/reference); the numbers
compared and their limits are the last lines on standard error and the
`checks` key, last, of the result line. `--control 1` runs the cell's
lower-precision control in the program's place instead (see PERF.md); the
benchmark's own runs never do.

Needs an NVIDIA card: without one (or with fewer than the cell asks for)
it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "freeze_omni_tpu")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"),
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(declared: list, ctx: dict) -> dict:
    """Every declared metric's value; a declared metric with no value stops
    the run (a short line is never printed)."""
    out = {}
    for m in declared:
        v = load_reader(m["name"])(ctx)
        if v is None:
            raise SystemExit(f"metric {m['name']} has no value in this run; "
                             f"no result line is printed")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def set_cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = BENCH / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def result_line(bench: dict, cell: dict, out: dict, trace: bool,
                device: dict) -> dict:
    from benchmark import judge, trace as trace_mod

    conf = out["conf"]
    ctx = {"setup_s": out["setup_s"], "window_s": out["window_s"],
           "win": out["win"], "spans": out["spans"],
           "trace": out.get("trace"), "launches": out.get("launches"),
           "dims": conf["dims"], "precision": conf["precision"]}
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(cell_metrics(bench, cell["name"], kind), ctx)
    checks = judge.checks_of(out["numbers"], conf["limits"])
    line = {"correct": judge.passed(checks) and bool(out["numbers"]["drained"]),
            "attempted": out["win"]["attempted"], "failed": out["win"]["failed"],
            "metrics": metrics, "device": device}
    if trace:
        line["device"]["window_s"] = out["trace"]["window_s"]
        line["device"]["busy_s"] = out["trace"]["busy_s"]
        line["breakdown"] = trace_mod.breakdown(out["trace"])
    line["checks"] = checks
    return line


def _pct(xs, q) -> float:
    import numpy as np

    return 1e3 * float(np.percentile(xs, q)) if xs else float("nan")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=[0, 1])
    p.add_argument("--control", type=int, default=0, choices=[0, 1])
    args = p.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    set_cache_env()
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from benchmark import harness
    from benchmark.traffic import load_mix

    with open(BENCH / "configs" / f"{cell['config']}.json") as f:
        conf = json.load(f)
    mix = load_mix(cell["traffic"])
    spec = dict(cell)
    spec["kernels"] = [m["name"].split("_roofline")[0]
                       for m in cell_metrics(bench, cell["name"], "per_layer")
                       if m["name"].endswith("_roofline")] if args.trace else []
    out = harness.execute(spec, conf, mix, args.seed, args.seconds,
                          bool(args.trace), "cuda", control=bool(args.control),
                          log=lambda *a: print(*a, file=sys.stderr))
    out["conf"] = conf
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(out["peak"])}
    line = result_line(bench, cell, out, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    win = out["win"]
    late = out["late"]
    print(f"[run] {args.workload} seed {args.seed}: setup {out['setup_s']:.3f} s, "
          f"window {out['window_s']:.3f} s, {out['steps']} ticking steps, "
          f"{win['attempted']} user features, peak {out['peak']}; "
          f"sender lateness p95/max "
          f"{(sorted(late)[int(0.95 * (len(late) - 1))] if late else 0.0):.4f}/"
          f"{(max(late) if late else 0.0):.4f} s; backlog at open/close "
          f"{win['backlog'][0]:.3f}/{win['backlog'][1]:.3f} windows; "
          f"stream_rate {win['stream_rate']:.4f}; latency p50/p95 "
          f"{_pct(win['latencies'], 50):.1f}/{_pct(win['latencies'], 95):.1f} ms "
          f"({len(win['latencies'])}); probe {out['probe']}",
          file=sys.stderr)
    print(f"[host] {json.dumps(out['host'])}", file=sys.stderr)
    print(f"[numbers] {json.dumps(out['numbers'])}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
