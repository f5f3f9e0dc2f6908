"""Time K3 and K4 (float-cache decode attention) at the serving paths'
shapes on the card.

    python -m freeze_omni_tpu_torch.bin.k4_profile [--seed 0]
    PYTHONPATH=<other checkout> python <this file>   # that checkout's K3/K4

Seeded random caches at four shapes: one speech-decoder layer of the
int8 response path's BatchedTTS pool (phase 7 of chip_smoke.py: B = 8,
S = 465, 14 heads of 64, f32, 309 visible slots a row), of the int4
service's pool (phase 9: B = 4 rows of 1521 slots at SERVICE_POOL_LENGTHS),
first_response's decoder cache (B = 8, S = 2048, 73..123 visible) and the
LLM's text decode on a bf16 cache (`--kv_quant 0`: B = 8, 28 heads, 4 kv
heads of 128, S = 2048, 530-560 visible). For K3 and K4 at each: the eager
time per call (CUDA events around back-to-back calls, the host's time per
call included), the device time per call (the calls captured in a CUDA
graph and replayed), the same with the cache cold in the 50 MB L2 (the
captured calls rotate over copies of the cache, as the speech decoder's
four layers, each with its own cache, and their weights evict each other)
and each kernel's device time (`torch.profiler`), beside the bound (`decode_bound`:
max(bytes / 3.35 TB/s, operations / 989 TFLOP/s)) and one
scaled_dot_product_attention call with the length mask (`sdpa_masked`:
the same function, timed only, never on the port's path); chip_smoke.py
takes both from here. Imports the package by its absolute name, so
PYTHONPATH picks the checkout that is timed (one that has bin/timing.py).
Prints the card's name and power limit first and one JSON line last.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import time

import torch
import torch.nn.functional as F

from freeze_omni_tpu_torch.bin.timing import (bound, cuda_time_ms, graph_time_ms,
                                              kernel_times_ms)
from freeze_omni_tpu_torch.ops import attention as att

# the lengths of the int4 service's pool rows (S = 1521) at the deepest K4
# call of chip_smoke.py's phase 9 (seed 0; recorded on an H100)
SERVICE_POOL_LENGTHS = (1289, 1289, 1301, 1301)
KERNELS = ("decode_attention", "decode_attention_blocked")
L2_BYTES = 50 * 2 ** 20


def shapes(g):
    """(label, B, H, Hkv, dk, S, cache dtype, length int32 on the card)."""
    llm = torch.randint(530, 561, (8,), generator=g, device="cuda")
    out = [("pool B=8 S=465 f32", 8, 14, 14, 64, 465, torch.float32, [309] * 8),
           ("service pool B=4 S=1521 f32", 4, 14, 14, 64, 1521, torch.float32,
            list(SERVICE_POOL_LENGTHS)),
           ("first response B=8 S=2048 f32", 8, 14, 14, 64, 2048, torch.float32,
            torch.linspace(73, 123, 8).round().tolist()),
           ("LLM text decode B=8 S=2048 bf16", 8, 28, 4, 128, 2048,
            torch.bfloat16, llm.tolist())]
    return [(*s[:-1], torch.tensor(s[-1], device="cuda").to(torch.int32))
            for s in out]


def decode_bound(q, k, length):
    """The bound (bytes or operations) of decode attention of q [B, H, dk]
    on cache k [B, S, Hkv, dk] with `length`: the visible K and V slots
    once, q and out once, length; 4 * H * dk operations a visible slot.
    Returns (ms, "bytes" | "operations")."""
    B, H, dk = q.shape
    Hkv = k.shape[2]
    n_vis = int(length.long().sum())
    nbytes = n_vis * Hkv * dk * 2 * k.element_size() \
        + 2 * q.numel() * q.element_size() + length.numel() * 4
    return bound(nbytes, 4 * n_vis * H * dk)


def sdpa_masked(q, k, v, length):
    """One scaled_dot_product_attention call of the same function: q as one
    query token, the cache as [B, Hkv, S, dk] views, the length mask and
    GQA. A yardstick, never on the port's path."""
    S = k.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            < length.long()[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def time_decode(fn, q, k, v, length):
    """fn(q, k, v, length) timed: eager_ms (back-to-back calls), host_ms
    (the host's time to issue one call: a host clock around back-to-back
    calls, no synchronisation inside), device_ms (a CUDA-graph replay, the
    cache warm in L2 after the first call) and cold_ms (a CUDA-graph replay
    whose calls rotate over copies of k and v, so that twice the L2's bytes
    of visible cache lie between two calls on one copy)."""
    visible = int(length.long().sum()) * k.shape[2] * k.shape[3] * 2 * k.element_size()
    n = max(2, -(-2 * L2_BYTES // max(visible, 1)))
    copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n - 1)]
    turn = itertools.cycle(copies)

    def rotating():
        kc, vc = next(turn)
        return fn(q, kc, vc, length)

    eager_ms = cuda_time_ms(lambda: fn(q, k, v, length))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fn(q, k, v, length)
    host_ms = (time.perf_counter() - t0) * 10.0
    out = {"eager_ms": eager_ms, "host_ms": host_ms,
           "device_ms": graph_time_ms(lambda: fn(q, k, v, length)),
           "cold_ms": graph_time_ms(rotating, calls=2 * n), "copies": n}
    del copies
    return out


def splits_of(B, H, Hkv, dk, S):
    """K4's splits a (row, kv head) in the checkout that is timed (None where
    it has no decode_plan)."""
    plan = getattr(att, "decode_plan", None)
    return plan(B, H, Hkv, dk, S).splits if plan else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = []
    for label, B, H, Hkv, dk, S, dtype, length in shapes(g):
        q = torch.randn((B, H, dk), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((B, S, Hkv, dk), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        a = (q, k, v, length)
        calls = {name: (lambda a=a, fn=getattr(att, name): fn(*a)) for name in KERNELS}
        cases.append((label, a, calls, splits_of(B, H, Hkv, dk, S)))
    # every timing before the profiler's
    rows = []
    for label, a, calls, splits in cases:
        b_ms, b_by = decode_bound(a[0], a[1], a[3])
        sdpa = sdpa_masked(*a)
        rows.append({"shape": label, "lengths": a[3].tolist(), "splits": splits,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "sdpa_ms": cuda_time_ms(sdpa), "sdpa_device_ms": graph_time_ms(sdpa),
                     **{name: time_decode(getattr(att, name), *a) for name in KERNELS}})
    for row, (_, _, calls, _) in zip(rows, cases):
        for name, call in calls.items():
            row[name]["kernels_ms"] = kernel_times_ms(call)
            r = row[name]
            print(f"{row['shape']} {name}: eager {r['eager_ms']:.4f} ms (host "
                  f"{r['host_ms']:.4f}), device "
                  f"{r['device_ms']:.4f} ms, cold L2 {r['cold_ms']:.4f} ms ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["kernels_ms"].items())
                  + f"), bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
                  f"splits {row['splits']}, sdpa {row['sdpa_ms']:.4f} ms eager "
                  f"{row['sdpa_device_ms']:.4f} ms device", flush=True)
    print(json.dumps({"card": card, "k3_k4": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
