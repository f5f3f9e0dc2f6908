"""Time K2 (int8-KV chunk-prefill attention) at the serving paths' shapes on
the card.

    python -m freeze_omni_tpu_torch.bin.k2_profile [--seed 0]
    PYTHONPATH=<other checkout> python <this file>   # that checkout's K2

Seeded random int8 caches at Qwen2-7B's attention widths (28 heads, 4 kv
heads of 128) for B = 8 rows: the dual tick (T = 29, tokens 8-11 and 25-28
valid, 530-560 visible slots a row, S = 1024 and 2048), the text step
(T = 1, qend = length + 1) and the role prefill (T = 89, every token
valid). For each: the eager time per call (CUDA events around back-to-back
calls), the device time per call (the calls captured in a CUDA graph and
replayed) and each kernel's device time (`torch.profiler`), beside the
bound (`k2_bound`: max(bytes / 3.35 TB/s, operations / 989 TFLOP/s)) and
scaled_dot_product_attention on the cache dequantized to bf16 before the
timed window (`sdpa_bf16`: a reference ceiling, not the same function,
never on the port's path); chip_smoke.py takes both from here. Imports
the package by its absolute name, so PYTHONPATH picks the checkout that
is timed (one that has bin/timing.py). Prints the card's name and power
limit first and one JSON line last. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from freeze_omni_tpu_torch.bin.timing import (bound, cuda_time_ms, graph_time_ms,
                                              kernel_times_ms)
from freeze_omni_tpu_torch.ops import attention as att

H, HKV, DK, B = 28, 4, 128, 8
TICK_VALID = (8, 9, 10, 11, 25, 26, 27, 28)


def shapes(g):
    """(label, S, qend [B, T] int32 on the card)."""
    lengths = torch.randint(530, 561, (B,), generator=g, device="cuda")
    tick = torch.zeros((B, 29), dtype=torch.long, device="cuda")
    for rank, t in enumerate(TICK_VALID):
        tick[:, t] = lengths + rank + 1
    role = torch.arange(1, 90, device="cuda").expand(B, 89)
    out = [("tick T=29 S=1024", 1024, tick),
           ("tick T=29 S=2048", 2048, tick),
           ("text step T=1 S=1024", 1024, (lengths + 1)[:, None]),
           ("role prefill T=89 S=1024", 1024, role)]
    return [(label, S, qend.to(torch.int32).contiguous()) for label, S, qend in out]


def k2_bound(qend, H, Hkv, dk):
    """K2's bound (bytes or operations) for qend [B, T]: each row's int8 K
    and V and their scales up to its largest qend once, q of the valid
    tokens, out of every token (bf16) and qend; 4 * H * dk operations a
    visible slot and valid token. Returns (ms, "bytes" | "operations")."""
    B, T = qend.shape
    qe = qend.long()
    nbytes = int(qe.amax(dim=1).sum()) * Hkv * (2 * dk + 2 * 4) \
        + (int((qe > 0).sum()) + B * T) * H * dk * 2 + qend.numel() * 4
    return bound(nbytes, int(qe.sum()) * H * dk * 4)


def sdpa_bf16(q, k_q, k_scale, v_q, v_scale, qend):
    """A call of scaled_dot_product_attention on K/V dequantized to bf16
    here (before any timed window), with the qend mask and GQA: a
    reference ceiling for K2, not the same function, never on the port's
    path."""
    S = k_q.shape[1]
    kd, vd = ((c.float() * s[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
              for c, s in ((k_q, k_scale), (v_q, v_scale)))
    mask = (torch.arange(S, device=q.device)[None, None, :]
            < qend[:, :, None])[:, None]
    qs = q.permute(0, 2, 1, 3)
    return lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_profile: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = []
    for label, S, qend in shapes(g):
        T = qend.shape[1]
        q = torch.randn((B, T, H, DK), generator=g, device="cuda").to(torch.bfloat16)
        k_q, v_q = (torch.randint(-127, 128, (B, S, HKV, DK), generator=g,
                                  device="cuda", dtype=torch.int8) for _ in range(2))
        k_s, v_s = (0.01 + 0.05 * torch.rand((B, S, HKV), generator=g, device="cuda")
                    for _ in range(2))
        args = (q, k_q, k_s, v_q, v_s, qend)
        cases.append((label, qend, lambda a=args: att.prefill_quant(*a), sdpa_bf16(*args)))
    # every timing before the profiler's
    rows = [{"shape": label, "eager_ms": cuda_time_ms(call),
             "device_ms": graph_time_ms(call),
             "bound_ms": k2_bound(qend, H, HKV, DK)[0],
             "sdpa_bf16_ms": graph_time_ms(sdpa)}
            for label, qend, call, sdpa in cases]
    for row, (_, _, call, _) in zip(rows, cases):
        row["kernels_ms"] = kernel_times_ms(call)
        print(f"{row['shape']}: eager {row['eager_ms']:.4f} ms, device "
              f"{row['device_ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in row["kernels_ms"].items())
              + f"), bound {row['bound_ms']:.5f} ms, sdpa bf16 "
              f"{row['sdpa_bf16_ms']:.4f} ms", flush=True)
    print(json.dumps({"card": card, "k2": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
