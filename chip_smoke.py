#!/usr/bin/env python3
"""Smoke test of the PyTorch port (freeze_omni_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Runs the duplex dialog-state serving tick, the port's main path, on the card
with no fallback anywhere; any failing phase raises and the script exits
nonzero without printing a result. Phases:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: every kernel of the path from freeze_omni_tpu_torch/csrc with nvcc
   for sm_90a, all sources at once (ptxas register/spill report printed);
3. kernel parity at flagship shapes in bf16: K1 (int8 weight-only matmul) at
   every projection shape for N in {1, 89, 232, 1856}; K2 (int8-KV prefill
   attention) at B=8, T=29, H=28, Hkv=4, dk=128, S in {1024, 2048} with
   ragged qend including 0 and a non-finite scale in slot S-1. Each kernel
   against its plain PyTorch version on the same inputs, rtol = atol = 2e-2
   on valid rows (one bf16 rounding of the output); qend=0 rows must be
   finite;
4. slice parity at full width and reduced depth: the flagship widths with 2
   LLM layers, int8 weights and int8 KV, f32 activations; the same weights
   and fbank windows through the engine on the card (kernels) and on the CPU
   (plain versions) for a few dual ticks; probabilities within 5e-3 (int8 KV
   re-quantization flips on 1-ulp activation differences), decisions at the
   0.5 threshold and KV lengths identical. TF32 is off for this phase;
5. the main path at full width and depth: flagship_system() (Qwen2-7B
   widths, 28 layers) with int8 weights from the torch-side random init, a
   bf16 frontend, kv_quant_bits=8, max_kv_len=1024 and 8 sessions with the
   default role; full-duplex dual ticks from dev wavs through the
   GatingChunker, each tick gating that tick's audio chunk of all 16
   streams, until a KV roll has fired and at least 100 ticks ran. The
   kernels' launch counts are zeroed just before and read just after; both
   must be > 0. Prints tick p50/p90 (host frontend + engine.tick, and each
   alone) against the 224 ms budget and the peak device memory;
6. kernel times with CUDA events at the main path's shapes, each beside its
   bound: max(bytes / 3.35 TB/s, operations / 989 TFLOP/s), counting each
   input byte once and, for K2, only the cache slots this run's qend makes
   visible. K1's entry sums one layer's seven projection calls at N = 232.

The last lines: the nvidia-smi line, one {"kernels": [...]} JSON line and
the device JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
BUDGET_MS = 224.0              # one gating chunk of audio


def log(*a):
    print(*a, flush=True)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def cuda_time_ms(fn, iters=50, warmup=5):
    import torch

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


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_violation(out, ref, tol):
    """max |out - ref| and whether every element is within atol + rtol*|ref|."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    return float(err.max()), bool((err <= tol + tol * ref.abs()).all())


class Feed:
    """One identity of one session: its audio and per-chunk statuses, gated by
    its own GatingChunker one 224 ms chunk per tick, as the duplex service
    does. An ipu_sl chunk queues its onset replay ahead of itself, so the
    submissions run behind the audio by the replay's length; one queued
    window is submitted per tick."""

    def __init__(self, gating_cfg, audio, statuses):
        from freeze_omni_tpu_torch.frontend.chunker import GatingChunker

        self.chunker = GatingChunker(gating_cfg)
        self.audio, self.statuses = audio, statuses
        self.queue = []

    def next(self, tick):
        from freeze_omni_tpu_torch.frontend.chunker import gate_stream

        n = self.chunker.cfg.samples_per_chunk
        if tick < len(self.statuses):
            self.queue += gate_stream(self.chunker,
                                      self.audio[tick * n:(tick + 1) * n],
                                      [self.statuses[tick]])
        return self.queue.pop(0) if self.queue else None


def session_feeds(gating_cfg, n_sessions, n_chunks):
    """Per session: user and system feeds from the committed dev wavs (offset
    per session), each an IPU that opens after a short silence."""
    import glob

    import numpy as np

    from freeze_omni_tpu_torch.frontend.wav import read_wav

    wav_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "freeze_omni_tpu", "assets", "tiny_s2s", "dev_wavs")
    asr = np.concatenate([read_wav(p)[0] for p in
                          sorted(glob.glob(os.path.join(wav_dir, "asr_*.wav")))])
    qa = np.concatenate([read_wav(p)[0] for p in
                         sorted(glob.glob(os.path.join(wav_dir, "qa_*.wav")))])
    n = gating_cfg.samples_per_chunk
    need = (n_chunks + 8) * n
    asr = np.tile(asr, need // len(asr) + 2)
    qa = np.tile(qa, need // len(qa) + 2)
    feeds = []
    for s in range(n_sessions):
        off = s * 5 * n
        user = Feed(gating_cfg, asr[off:off + need],
                    [None] * (1 + s % 3) + ["ipu_sl"] + ["ipu_cl"] * n_chunks)
        system = Feed(gating_cfg, qa[off:off + need],
                      ["ipu_sl"] + ["ipu_cl"] * (n_chunks + 4))
        feeds.append({"user": user, "system": system})
    return feeds


def submit_tick(engines, sids, feeds, tick):
    """Gate this tick's audio chunk for both identities of every session (the
    host frontend: fbank + gating) and submit each identity's next queued
    window to every engine."""
    for sid, feed in zip(sids, feeds):
        for ident in ("user", "system"):
            item = feed[ident].next(tick)
            if item is not None:
                for engine in engines:
                    engine.submit_chunk(sid, ident, *item)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, count, smi


def phase_build():
    from freeze_omni_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build()
    log(f"[build] {len(info)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for name, v in info.items():
        log(f"[build] {name}: {v['seconds']:.2f} s")
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


K1_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))


def k1_inputs(N, K, O, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (K, O), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = (torch.rand(O, generator=g, device="cuda") + 0.5) / (127.0 * K ** 0.5)
    return x, w_q, scale


def k2_inputs(B, T, H, Hkv, dk, S, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((B, T, H, dk), generator=g, device=dev).to(torch.bfloat16)
    k_q = torch.randint(-127, 128, (B, S, Hkv, dk), generator=g, device=dev,
                        dtype=torch.int8)
    v_q = torch.randint(-127, 128, (B, S, Hkv, dk), generator=g, device=dev,
                        dtype=torch.int8)
    k_s = 0.01 + 0.05 * torch.rand((B, S, Hkv), generator=g, device=dev)
    v_s = 0.01 + 0.05 * torch.rand((B, S, Hkv), generator=g, device=dev)
    lengths = torch.randint(S // 8, S - T - 1, (B,), generator=g, device=dev)
    qend = lengths[:, None] + torch.arange(1, T + 1, device=dev)[None, :]
    qend = torch.where(torch.rand((B, T), generator=g, device=dev) < 0.3,
                       torch.zeros_like(qend), qend)
    qend[-1] = 0
    k_s[:, S - 1] = float("nan")   # the scratch slot may hold anything
    v_s[:, S - 1] = float("inf")
    return q, k_q, k_s, v_q, v_s, qend.to(torch.int32)


def phase_kernel_parity():
    import torch

    from freeze_omni_tpu_torch.ops import attention as att
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    tol = 2e-2
    k1_err = 0.0
    for (K, O) in K1_SHAPES:
        for N in (1, 89, 232, 1856):
            x, w_q, scale = k1_inputs(N, K, O, seed=N + K + O)
            y = qm.quant_matmul(x, w_q, scale)
            ref = qm.quant_matmul_reference(x, w_q, scale)
            torch.cuda.synchronize()
            err, ok = max_violation(y, ref, tol)
            k1_err = max(k1_err, err)
            log(f"[parity] K1 N={N} K={K} O={O}: max_abs_err {err:.3e}")
            if not ok or not torch.isfinite(y.float()).all():
                raise AssertionError(f"K1 disagrees with its plain version at "
                                     f"N={N} K={K} O={O}: {err}")
    k2_err = 0.0
    for S in (1024, 2048):
        q, k_q, k_s, v_q, v_s, qend = k2_inputs(8, 29, 28, 4, 128, S, seed=S)
        out = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
        ref = att.prefill_quant_reference(q, k_q, k_s, v_q, v_s, qend)
        torch.cuda.synchronize()
        valid = qend > 0
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"K2 wrote non-finite values at S={S}")
        err, ok = max_violation(out[valid], ref[valid], tol)
        k2_err = max(k2_err, err)
        log(f"[parity] K2 B=8 T=29 H=28 Hkv=4 dk=128 S={S}: max_abs_err "
            f"{err:.3e} on {int(valid.sum())} valid rows; qend=0 rows finite")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at S={S}")
    return k1_err, k2_err


def phase_slice_parity():
    import dataclasses

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_system()
    llm = dataclasses.replace(cfg.audio_llm.llm, num_layers=2, max_kv_len=1024)
    cfg = dataclasses.replace(
        cfg, audio_llm=dataclasses.replace(cfg.audio_llm, llm=llm),
        serving=dataclasses.replace(cfg.serving, max_sessions=2, kv_quant_bits=8))
    params = audio_llm.init_params(cfg.audio_llm, seed=1, device="cuda",
                                   quantize_llm=True)
    cpu_params = tree_to(params, "cpu")
    gpu = ServingEngine(cfg, params, device="cuda")
    cpu = ServingEngine(cfg, cpu_params, device="cpu")
    sids = ["p0", "p1"]
    for sid in sids:
        gpu.open_session(sid)
        cpu.open_session(sid)
    n_ticks = 5
    feeds = session_feeds(cfg.duplex.gating, len(sids), n_ticks)
    atol, thr, worst, compared = 5e-3, cfg.duplex.resp_threshold, 0.0, 0
    for tick in range(n_ticks):
        submit_tick((gpu, cpu), sids, feeds, tick)
        go, co = gpu.tick().get("user", {}), cpu.tick().get("user", {})
        if sorted(go) != sorted(co):
            raise AssertionError(f"tick {tick}: predicted slots differ")
        for slot in go:
            for key in ("state_1", "state_2"):
                pg, pc = go[slot][key], co[slot][key]
                worst = max(worst, abs(pg - pc))
                compared += 1
                if not (np.isfinite(pg) and abs(pg - pc) <= atol):
                    raise AssertionError(f"tick {tick} slot {slot} {key}: card "
                                         f"{pg} vs cpu {pc}")
                if abs(pc - thr) > atol and (pg > thr) != (pc > thr):
                    raise AssertionError(f"tick {tick}: decision differs")
        gl = gpu.store.caches.kv.length.cpu().tolist()
        cl = cpu.store.caches.kv.length.tolist()
        if gl != cl:
            raise AssertionError(f"tick {tick}: KV lengths {gl} vs {cl}")
    if compared == 0:
        raise AssertionError("no user prediction was compared")
    log(f"[slice-parity] 2-layer flagship widths, {n_ticks} dual ticks x 2 "
        f"sessions: card vs cpu max |dprob| {worst:.3e} over {compared} "
        f"probabilities (atol {atol}); KV lengths equal")
    del gpu, cpu, params, cpu_params
    torch.cuda.empty_cache()


def phase_main_path():
    import dataclasses

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.ops import attention as att
    from freeze_omni_tpu_torch.ops import quant_matmul as qm
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine

    torch.backends.cudnn.allow_tf32 = True  # serving default
    cfg = flagship_system()
    llm = dataclasses.replace(cfg.audio_llm.llm, max_kv_len=1024)
    cfg = dataclasses.replace(
        cfg, audio_llm=dataclasses.replace(cfg.audio_llm, llm=llm),
        serving=dataclasses.replace(cfg.serving, max_sessions=8, kv_quant_bits=8))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = audio_llm.init_params(cfg.audio_llm, seed=0, device="cuda",
                                   quantize_llm=True)
    torch.cuda.synchronize()
    log(f"[main] flagship int8 params drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, params, kv_dtype=torch.bfloat16, device="cuda")
    sids = [f"s{i}" for i in range(cfg.serving.max_sessions)]
    max_ticks = 200
    feeds = session_feeds(cfg.duplex.gating, len(sids), max_ticks)

    qm.quant_matmul.launches = 0
    att.prefill_quant.launches = 0
    t0 = time.perf_counter()
    for sid in sids:
        engine.open_session(sid)
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    at_open = {"quant_matmul": qm.quant_matmul.launches,
               "prefill_quant": att.prefill_quant.launches}
    front_ms, engine_ms, rolls, tick = [], [], 0, 0
    prev = engine.store.caches.kv.length.cpu()
    probs_seen = 0
    while tick < max_ticks and (tick < 100 or rolls == 0):
        t0 = time.perf_counter()
        submit_tick((engine,), sids, feeds, tick)
        t1 = time.perf_counter()
        out = engine.tick().get("user", {})
        t2 = time.perf_counter()
        front_ms.append((t1 - t0) * 1e3)
        engine_ms.append((t2 - t1) * 1e3)
        for pred in out.values():
            p = np.array([pred["state_1"], pred["state_2"]])
            if not (np.isfinite(p).all() and (p >= 0).all() and p.sum() <= 1 + 1e-5):
                raise AssertionError(f"tick {tick}: bad state probabilities {pred}")
            probs_seen += 1
        lengths = engine.store.caches.kv.length.cpu()
        rolls += int((lengths < prev).sum())
        prev = lengths
        tick += 1
    launches = {"quant_matmul": qm.quant_matmul.launches,
                "prefill_quant": att.prefill_quant.launches}
    if rolls == 0:
        raise AssertionError(f"no KV roll fired in {tick} ticks")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    # first 5 ticks excluded (warm-up)
    front, eng = np.array(front_ms[5:]), np.array(engine_ms[5:])
    whole = front + eng

    def pct(a):
        return f"p50 {np.percentile(a, 50):.2f} ms, p90 {np.percentile(a, 90):.2f} ms"

    peak = torch.cuda.max_memory_allocated()
    log(f"[main] 8 sessions opened (role prefill + pool seed) in {open_s:.2f} s")
    log(f"[main] {tick} dual ticks, {probs_seen} user predictions, {rolls} "
        f"session KV rolls; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    log(f"[main] tick with host frontend (16 chunks gated) {pct(whole)} against "
        f"the {BUDGET_MS:.0f} ms budget; host frontend alone {pct(front)}; "
        f"engine.tick alone {pct(eng)}")
    per_tick = {k: (launches[k] - at_open[k]) / tick for k in launches}
    return engine, launches, per_tick


def phase_kernel_times(engine, launches, per_tick, errs, smi):
    import torch

    from freeze_omni_tpu_torch.ops import attention as att
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    cfg = engine.cfg.audio_llm.llm
    layers = engine.core.params["llm"]["layers"]
    N = engine.store.max_sessions * 29   # 8+4+13+4 tokens per session per dual tick
    g = torch.Generator(device="cuda").manual_seed(7)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        w_q, scale = layers[name]["w_q"][0], layers[name]["scale"][0]
        K, O = w_q.shape
        x = torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
        w_t = w_q.t().contiguous()            # the library call wants [O, K]
        s_b = scale.to(torch.bfloat16)        # and scales in x's dtype
        ms = cuda_time_ms(lambda: qm.quant_matmul(x, w_q, scale))
        plain = cuda_time_ms(lambda: qm.quant_matmul_reference(x, w_q, scale), iters=10)
        lib = cuda_time_ms(lambda: torch._weight_int8pack_mm(x, w_t, s_b))
        nbytes = K * O + 4 * O + 2 * N * K + 2 * N * O
        nops = 2 * N * K * O
        b_ms, b_by = bound(nbytes, nops)
        log(f"[time] K1 {name} N={N} K={K} O={O}: kernel {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain:.4f} ms, "
            f"torch._weight_int8pack_mm {lib:.4f} ms")
        k1["ms"] += ms
        k1["plain_ms"] += plain
        k1["library_ms"] += lib
        k1["bytes"] += nbytes
        k1["ops"] += nops
    k1_bound, k1_by = bound(k1["bytes"], k1["ops"])

    # K2 on the live layer-0 cache after the main run, with the qend of a
    # regular tick: prefixes masked, both identities' 4 chunk tokens valid
    kv = engine.store.caches.kv
    B, S = kv.k.shape[1], kv.k.shape[2]
    H, Hkv, dk = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mask = torch.zeros((B, 29), dtype=torch.bool, device="cuda")
    mask[:, 8:12] = True
    mask[:, 25:29] = True
    rank = torch.cumsum(mask.long(), 1) - 1
    qend = torch.where(mask, kv.length.long()[:, None] + rank + 1,
                       torch.zeros_like(rank)).to(torch.int32)
    q = torch.randn((B, 29, H, dk), generator=g, device="cuda").to(torch.bfloat16)
    args = (q, kv.k[0], kv.k_scale[0], kv.v[0], kv.v_scale[0], qend)
    k2_ms = cuda_time_ms(lambda: att.prefill_quant(*args))
    k2_plain = cuda_time_ms(lambda: att.prefill_quant_reference(*args), iters=10)
    visible = qend.long().amax(dim=1)                       # slots each row reads
    k2_bytes = int(visible.sum()) * Hkv * (2 * dk + 2 * 4) + 2 * q.numel() * 2 \
        + qend.numel() * 4
    k2_ops = int(qend.long().sum()) * H * dk * 4
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    log(f"[time] K2 B={B} T=29 S={S} visible slots/row {visible.tolist()}: "
        f"kernel {k2_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}), plain "
        f"{k2_plain:.4f} ms")
    return [
        {"name": "quant_matmul (K1, one layer's 7 projections at N=232)",
         "route": "cuda", "source": "freeze_omni_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "freeze_omni_tpu/ops/quant_matmul.py:41",
         "launches": launches["quant_matmul"], "max_abs_err": errs[0],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1["library_ms"],
         "launches_per_tick": per_tick["quant_matmul"], "card": smi},
        {"name": "prefill_quant (K2, one layer at B=8 T=29 S=1024)",
         "route": "cuda", "source": "freeze_omni_tpu_torch/csrc/prefill_quant.cu",
         "replaces": "freeze_omni_tpu/ops/attention.py:190",
         "launches": launches["prefill_quant"], "max_abs_err": errs[1],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "launches_per_tick": per_tick["prefill_quant"], "card": smi},
    ]


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the card", file=sys.stderr)
        return 2
    import freeze_omni_tpu_torch  # noqa: F401  (fails outside a checkout)

    name, count, smi = phase_device()
    phase_build()
    errs = phase_kernel_parity()
    phase_slice_parity()
    engine, launches, per_tick = phase_main_path()
    kernels = phase_kernel_times(engine, launches, per_tick, errs, smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
