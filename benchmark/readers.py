"""Shared readers of the per-layer and end-to-end metrics. Each metric is
a file `metrics/<name>.py` whose `read(ctx)` returns its value, or None
where its source holds nothing to read (the harness then refuses to print
a line that lacks a declared metric). `ctx` keys: setup_s, window_s,
win (stream_rate, latencies), spans (step, frontend, dispatch: seconds a
ticking step), trace (trace.reduce) and launches (harness.Launches) of a
traced run, dims and precision of the configuration."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import roofline


def span_ms(ctx: dict, name: str) -> Optional[float]:
    xs = ctx.get("spans", {}).get(name) or []
    return 1e3 * float(np.mean(xs)) if xs else None


def device_idle(ctx: dict) -> Optional[float]:
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def _family_s(ctx: dict, fam: str) -> float:
    tr = ctx.get("trace")
    return roofline.family_seconds(tr["device"]).get(fam, 0.0) if tr else 0.0


def linear_roofline(ctx: dict, kind: str) -> Optional[float]:
    """Share of the bound of the projections of one kernel (k1 or k5) over
    their device time in the traced steps, counting each forward's valid
    rows."""
    la = ctx.get("launches")
    t = _family_s(ctx, kind)
    if not la or t <= 0:
        return None
    bits = 8 if kind == "k1" else 4
    group = ctx["precision"]["group"]
    b = sum(roofline.linear_bound(f["valid"], K, O, bits, group)
            for f in la["forwards"] for k, N, K, O in f["linear"] if k == kind)
    return 100.0 * b / t if b > 0 else None


def k2_roofline(ctx: dict) -> Optional[float]:
    la = ctx.get("launches")
    t = _family_s(ctx, "k2")
    if not la or t <= 0:
        return None
    m = ctx["dims"]["llm"]
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    dk = m["hidden"] // H
    b = sum(roofline.k2_bound(rows, H, Hkv, dk)
            for f in la["forwards"] for _, rows in f["k2"])
    return 100.0 * b / t if b > 0 else None


def model_flops(ctx: dict) -> float:
    """FLOPs the traced steps' valid work needs: the projections of every
    valid token, attention over each valid query's visible cache, and the
    encoder and adapter of the active rows."""
    la, d = ctx["launches"], ctx["dims"]
    m = d["llm"]
    H = m["num_heads"]
    dk = m["hidden"] // H
    lin = roofline.llm_linear_params(m)
    flops = 0.0
    for f in la["forwards"]:
        flops += 2.0 * lin * f["valid"]
        for _, rows in f["k2"]:
            flops += 4.0 * H * dk * sum(sum(q) for _, q in rows)
    for shape, active in la["frontends"]:
        t_in = shape[1]
        t_enc = ((t_in - 1) // 2 - 1) // 2
        flops += active * (roofline.encoder_flops(d["encoder"], t_in)
                           + roofline.adapter_flops(d["adapter"], t_enc))
    return flops


def mfu(ctx: dict) -> Optional[float]:
    tr, la = ctx.get("trace"), ctx.get("launches")
    if not tr or not la or tr["window_s"] <= 0:
        return None
    f = model_flops(ctx)
    return 100.0 * f / (tr["window_s"] * roofline.BF16_FLOPS) if f > 0 else None
