"""Profile K5 (grouped int4 matmul) at text-decode sizes on the card.

    python -m freeze_omni_tpu_torch.bin.k5_profile [--n 1 8 16]

For one Qwen2-7B layer's seven int4 projections (q, k, v, o, gate, up,
down; seeded random packed weights, group 64) and each N: the device time
of every kernel a call launches (`torch.profiler`, averaged over 20 calls)
beside `torch._weight_int4pack_mm`'s on the same weights, and the eager time
per call (CUDA events around back-to-back calls). First, the host's time per
call of the wrapper and of its pieces, on a shape small enough that the
device never holds the host back. Everything but the device times runs
before the profiler. Prints the card's name and power limit first. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..ops import quant_matmul as qm
from .timing import cuda_time_ms, kernel_times_ms

SHAPES = (("q", 3584, 3584), ("k", 3584, 512), ("v", 3584, 512),
          ("o", 3584, 3584), ("gate", 3584, 18944), ("up", 3584, 18944),
          ("down", 18944, 3584))
GROUP = 64


def _library(w_q4, scale4):
    """The same weights repacked for torch._weight_int4pack_mm (transposed,
    even row in the high nibble, zero points 0)."""
    w_t = w_q4.t().contiguous()
    packed = torch._convert_weight_to_int4pack(((w_t & 0xF) << 4) | (w_t >> 4), 8)
    sz = torch.stack([scale4, torch.zeros_like(scale4)], -1).to(torch.bfloat16)
    return lambda x: torch._weight_int4pack_mm(x, packed, GROUP, sz)


def _eager_us(fn):
    return 1e3 * cuda_time_ms(fn)


def _device_us(fn):
    """Device time per call of each kernel fn launches (name -> us)."""
    return {k: 1e3 * v for k, v in kernel_times_ms(fn).items()}


def _host_us(fn, n=3000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1, 8, 16])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5_profile: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    # host time per call where the device never waits: a tiny shape
    x = torch.randn(1, 128, device="cuda").to(torch.bfloat16)
    w_q4 = torch.randint(0, 256, (64, 128), device="cuda", dtype=torch.uint8)
    scale4 = torch.rand(2, 128, device="cuda")
    lib = _library(w_q4, scale4)
    pieces = {
        "quant_matmul4 (small path)": lambda: qm.quant_matmul4(x, w_q4, scale4, GROUP),
        "quant_matmul4 (tile path)": lambda: qm.quant_matmul4(x, w_q4, scale4, GROUP,
                                                              path="tile"),
        "torch._weight_int4pack_mm": lambda: lib(x),
        "argument checks": lambda: qm._check_cuda_args4(x, w_q4, scale4, GROUP),
        "x.new_empty": lambda: x.new_empty((1, 128)),
        "launch function, refused at once": lambda: qm._small_lib()(
            0, 0, 0, 0, 0, 0, 1, 128, 128, 3, 4, 1, 0),
    }
    for label, fn in pieces.items():
        print(f"host per call: {label} {_host_us(fn):.2f} us", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    weights = {}
    for name, K, O in SHAPES:
        w_q4 = torch.randint(0, 256, (K // 2, O), generator=g, device="cuda",
                             dtype=torch.uint8)
        scale4 = (torch.rand((K // GROUP, O), generator=g, device="cuda")
                  + 0.5) / (7.0 * K ** 0.5)
        weights[name] = (w_q4, scale4, _library(w_q4, scale4))
    xs = {(N, name): torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
          for N in args.n for name, K, _ in SHAPES}
    # eager times first: the profiler's tracing may stay attached to the
    # launches that follow it
    eager = {}
    for (N, name), x in xs.items():
        w_q4, scale4, lib = weights[name]
        eager[N, name] = (_eager_us(lambda: qm.quant_matmul4(x, w_q4, scale4, GROUP)),
                          _eager_us(lambda: lib(x)))
    for N in args.n:
        totals = {"eager": 0.0, "device": 0.0, "lib_eager": 0.0, "lib_device": 0.0}
        for name, K, O in SHAPES:
            w_q4, scale4, lib = weights[name]
            x = xs[N, name]
            ours = _device_us(lambda: qm.quant_matmul4(x, w_q4, scale4, GROUP))
            theirs = _device_us(lambda: lib(x))
            ours_eager, lib_eager = eager[N, name]
            for key, v in (("eager", ours_eager), ("device", sum(ours.values())),
                           ("lib_eager", lib_eager),
                           ("lib_device", sum(theirs.values()))):
                totals[key] += v
            print(f"N={N} {name} K={K} O={O} plan {qm.small_plan(N, K, O, GROUP)}: "
                  f"eager {ours_eager:.1f} us, device "
                  + ", ".join(f"{k} {v:.1f}" for k, v in ours.items())
                  + f" us | library eager {lib_eager:.1f} us, device "
                  + ", ".join(f"{k} {v:.1f}" for k, v in theirs.items()) + " us",
                  flush=True)
        print(f"N={N} layer (us): " + ", ".join(f"{k} {v:.1f}" for k, v in totals.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
