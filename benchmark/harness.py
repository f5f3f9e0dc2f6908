"""One run of one cell: build the port's DuplexService as `bin/serve.py
--engine` builds it, drive it with the cell's traffic for the measured
window, optionally trace a fixed count of steps after it, and judge what
the served sessions decided against the plain reference.

The service is stepped here, one `DuplexService.step()` after another (the
server's ticker thread is never started). Audio goes in through
`enqueue_audio_data`, decisions come out as each session's
`dialog_state_update` events. The spans are the benchmark's own, around
public calls into the port's layers: `DuplexService.step`,
`ServingEngine.tick_submit` and the `deliver` of the handle it returns;
the frontend span is the host time of a step before its `tick_submit`.
"""

from __future__ import annotations

import gc
import resource
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic as traffic_mod
from .weights import LLM_PROJ, Weights, nest

IDENT = ("user", "system")
# after the window: how long the sessions' last features may take to be
# decided before the run counts them as never decided
DRAIN_TIMEOUT_S = 60.0


# --------------------------------------------------------------------------
# building the system under test
# --------------------------------------------------------------------------

def program_config(conf: dict, max_sessions: int):
    """The port's SystemConfig for a configuration file."""
    import dataclasses

    from freeze_omni_tpu_torch import config as pc

    d = conf["dims"]
    acfg = pc.AudioLLMConfig(
        encoder=pc.EncoderConfig(**d["encoder"]),
        adapter=pc.AdapterConfig(**d["adapter"]),
        llm=pc.LLMConfig(**d["llm"]),
        num_states=d["num_states"], task_num=d["task_num"])
    base = pc.SystemConfig(audio_llm=acfg)
    serving = dataclasses.replace(base.serving, max_sessions=max_sessions,
                                  pipeline_ticks=bool(conf["serving"]["pipeline_ticks"]),
                                  kv_quant_bits=conf["precision"]["kv_bits"])
    cfg = dataclasses.replace(base, serving=serving)
    _check_frontend(cfg, conf["frontend"])
    return cfg


def _check_frontend(cfg, fe: dict) -> None:
    """The reference's frontend settings are the served ones."""
    g, v = cfg.duplex.gating, cfg.duplex.vad
    served = {"chunk": g.samples_per_chunk, "sample_rate": v.sample_rate,
              "threshold": v.threshold, "min_silence_s": v.min_silence_s,
              "min_speech_s": v.min_speech_s, "speech_pad_s": v.speech_pad_s,
              "history_cache_chunks": v.history_cache_chunks,
              "user_vad": v.kind, "system_vad": v.system_kind,
              "steps_per_chunk": g.steps_per_chunk,
              "context_steps": g.context_steps,
              "onset_cache_size": g.onset_cache_size,
              "history_size": g.history_size}
    diff = {k: (fe.get(k), val) for k, val in served.items() if fe.get(k) != val}
    if diff:
        raise SystemExit(f"configuration frontend differs from the served "
                         f"one (file, served): {diff}")


def program_params(conf: dict, weights: Weights, bits: int, device) -> dict:
    """The benchmark's float weights, quantised by the port's own
    quantisers one layer at a time (the layers in `bits`, the embedding per
    row in int8, the lm_head in int8, as the weightless flagship serves)."""
    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.ops import quant

    qz = quant.quantize_linear if bits == 8 else quant.quantize_linear_int4
    params = {}
    for top in ("encoder_user", "encoder_system", "adapter_user",
                "adapter_system", "predictor"):
        params[top] = nest(dict(weights.items(top + "/")), top + "/")
    params["task_embeddings"] = weights.get("task_embeddings")
    layers = {}
    for name in ("ln1", "ln2"):
        layers[name] = {"scale": weights.get(f"llm/layers/{name}/scale")}
    for name in LLM_PROJ:
        path = f"llm/layers/{name}/w"
        L = weights.stack_of(path)
        stacked = None
        for i in range(L):
            q = qz({"w": weights.get(path, i)})
            if stacked is None:
                stacked = {k: torch.empty((L, *v.shape), dtype=v.dtype, device=device)
                           for k, v in q.items()}
            for k, v in q.items():
                stacked[k][i] = v
            del q
        if f"llm/layers/{name}/b" in weights.leaves:
            stacked["b"] = weights.get(f"llm/layers/{name}/b")
        layers[name] = stacked
    params["llm"] = {
        "layers": layers,
        "embed": quant.quantize_embedding({"w": weights.get("llm/embed/w")}),
        "final_norm": {"scale": weights.get("llm/final_norm/scale")},
        "lm_head": quant.quantize_linear({"w": weights.get("llm/lm_head/w")}),
    }
    return audio_llm.cast_frontend(params, torch.bfloat16)


def build_service(conf: dict, max_sessions: int, seed: int, device, bits: int):
    from freeze_omni_tpu_torch.runtime.service import DuplexService

    cfg = program_config(conf, max_sessions)
    weights = Weights(conf["dims"], seed, device)
    with torch.no_grad():
        params = program_params(conf, weights, bits, device)
    # --preset flagship --engine: bf16 KV and frontend, no synthesis
    svc = DuplexService(cfg, seed=seed, tts_params=None, params=params,
                        tokenizer=None, kv_dtype=torch.bfloat16, device=device)
    return svc, cfg


# --------------------------------------------------------------------------
# per-call bookkeeping, fed by the sessions' events
# --------------------------------------------------------------------------

@dataclass
class CallRec:
    lane: int
    k: int
    sid: str
    n_msgs: int
    open_step: int
    sampled: bool
    call: object = None
    close_step: Optional[int] = None
    pushed: int = 0
    due: List[float] = field(default_factory=list)      # open loop
    probs: Dict[str, List[float]] = field(default_factory=lambda: {i: [] for i in IDENT})
    status: Dict[str, list] = field(default_factory=lambda: {i: [] for i in IDENT})
    reads: Dict[int, List[int]] = field(default_factory=dict)   # step -> [u, s]
    feat_cum: List[int] = field(default_factory=list)   # user features after window j
    decisions: List[tuple] = field(default_factory=list)  # (s1, s2, t, step)
    submits: List[tuple] = field(default_factory=list)    # sampled calls
    user_submits: int = 0

    def features(self) -> int:
        return self.feat_cum[-1] if self.feat_cum else 0

    def processed(self) -> int:
        """User windows fully processed: read, gated and, where gated,
        decided (every feature generated up to the window has its
        decision)."""
        n = len(self.decisions)
        cum = self.feat_cum
        if not cum or cum[-1] <= n:
            return len(cum)
        lo, hi = 0, len(cum) - 1       # first j with cum[j] > n
        while lo < hi:
            mid = (lo + hi) // 2
            if cum[mid] > n:
                hi = mid
            else:
                lo = mid + 1
        return lo


class Run:
    def __init__(self, conf: dict, mix: dict, seed: int, device,
                 bits: Optional[int] = None):
        self.conf, self.mix = conf, mix
        self.seed, self.device = seed, device
        self.bits = conf["precision"]["weight_bits"] if bits is None else bits
        self.sessions = int(mix["sessions"])
        self.traffic = traffic_mod.Traffic(mix, seed)
        self.traffic.prepare()
        # the lanes the reference judges: drawn from the seed, with the one
        # whose first call is the longest among them
        rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x5A3])
        n_s = min(int(mix["sample_lanes"]), self.sessions)
        lanes = [int(x) for x in rng.choice(self.sessions, n_s, replace=False)]
        longest = max(range(self.sessions),
                      key=lambda lane: self.traffic.call(lane, 0).n_msgs)
        if longest not in lanes:
            lanes[-1] = longest
        self.sampled_lanes = set(lanes)
        self.calls: List[CallRec] = []
        self.by_sid: Dict[str, CallRec] = {}
        self.lanes: List[Optional[CallRec]] = [None] * self.sessions
        self.lane_next_k = [0] * self.sessions
        self.lane_free_at = [0.0] * self.sessions
        self.step_idx = 0
        self.onset = conf["frontend"]["onset_cache_size"]
        self.spans = {"step": [], "frontend": [], "dispatch": []}
        self.recording = False
        self.host_marks: List[tuple] = []
        self.late: List[float] = []     # open loop: send time - due time
        self._cur = None
        self.t0 = 0.0
        # traffic time = clock - offset; the open loop's warm-up advances it
        # by one message a step, so set-up leaves no backlog behind, and the
        # profiler's start is taken out of it
        self.offset = 0.0

    # ---- the service and its instrumentation ----------------------------

    def build(self):
        self.svc, self.cfg = build_service(self.conf, self.sessions, self.seed,
                                           self.device, self.bits)
        eng = self.svc.engine
        real_submit, real_tick = eng.submit_chunk, eng.tick_submit
        run = self

        def submit_chunk(sid, identity, fbank_chunk, is_sl):
            rec = run.by_sid.get(sid)
            if rec is not None:
                if identity == "user":
                    rec.user_submits += 1
                if rec.sampled:
                    # a copy: an onset replay feature is a view of the
                    # chunker's history ring, which moves on later
                    rec.submits.append((run.step_idx, identity, bool(is_sl),
                                        np.array(fbank_chunk, np.float32)))
            return real_submit(sid, identity, fbank_chunk, is_sl)

        class Delivery:
            __slots__ = ("handle",)

            def __init__(self, handle):
                self.handle = handle

            def deliver(self):
                t = time.perf_counter()
                out = self.handle.deliver()
                if run._cur is not None:
                    run._cur["deliver"] += time.perf_counter() - t
                return out

        def tick_submit():
            t = time.perf_counter()
            cur = run._cur
            if cur is not None:
                cur["frontend"] = t - cur["start"]
                cur["ticked"] = bool(eng._pending["user"] or eng._pending["system"])
                run._mark("bench.tick_submit")
            handle = real_tick()
            if cur is not None:
                cur["submit"] = time.perf_counter() - t
                run._mark("bench.deliver")
            return Delivery(handle)

        eng.submit_chunk = submit_chunk
        eng.tick_submit = tick_submit

    def now(self) -> float:
        return time.perf_counter() - self.offset

    # host spans of a traced window: (name, time.time_ns()) at each
    # boundary, name None where no span is open
    def _mark(self, name: Optional[str]):
        if self.recording:
            self.host_marks.append((name, time.time_ns()))

    def _open(self, lane: int, now: float) -> CallRec:
        k = self.lane_next_k[lane]
        self.lane_next_k[lane] = k + 1
        call = self.traffic.call(lane, k)
        rec = CallRec(lane=lane, k=k, sid=call.sid, n_msgs=call.n_msgs,
                      open_step=self.step_idx, sampled=lane in self.sampled_lanes,
                      call=call)
        sink = self.svc.open_session(rec.sid)
        run = self

        def on_vad(p, rec=rec):
            ident = p["identity"]
            rec.probs[ident].append(p["prob"])
            rec.status[ident].append(None)
            rec.reads.setdefault(run.step_idx, [0, 0])[ident == "system"] += 1
            if ident == "user":
                rec.feat_cum.append(rec.features())

        def on_event(p, rec=rec):
            ident, st = p["identity"], p["status"]
            rec.status[ident][-1] = st
            if ident == "user":
                rec.feat_cum[-1] += (1 + run.onset) if st == "ipu_sl" and run.onset \
                    else 1

        def on_decision(p, rec=rec):
            pr = p["probs"]
            rec.decisions.append((pr["state_1"], pr["state_2"], run.now(),
                                  run.step_idx))

        sink.on("vad_state_update", on_vad)
        sink.on("vad_event", on_event)
        sink.on("dialog_state_update", on_decision)
        self.calls.append(rec)
        self.by_sid[rec.sid] = rec
        self.lanes[lane] = rec
        if self.mix["mode"] == "open":
            start = self.lane_free_at[lane]
            rec.due = [start + (j + 1) * self.traffic.msg_s for j in range(rec.n_msgs)]
        return rec

    def _close(self, rec: CallRec, now: float) -> None:
        self.svc.close_session(rec.sid)
        rec.close_step = self.step_idx
        self.lanes[rec.lane] = None
        if self.mix["mode"] == "open":
            end = rec.due[-1] if rec.due else now
            self.lane_free_at[rec.lane] = max(now, end) + \
                self.traffic.call_gap(rec.lane, rec.k)

    def _push(self, rec: CallRec, upto: int) -> None:
        while rec.pushed < upto:
            j = rec.pushed
            for ident in IDENT:
                self.svc.enqueue_audio_data(rec.sid, ident, {
                    "audio": rec.call.message(ident, j), "sr": 16000})
            rec.pushed += 1

    def feed(self, now: float) -> None:
        """Close finished calls, open the lanes' next calls, and send what
        the mix's mode says is due."""
        lead = int(self.mix.get("lead_messages", 0))
        for lane in range(self.sessions):
            rec = self.lanes[lane]
            if rec is not None and rec.pushed == rec.n_msgs and \
                    rec.processed() == rec.n_msgs:
                self._close(rec, now)
                rec = None
            if rec is None:
                if self.mix["mode"] == "open":
                    start = self.lane_free_at[lane] if self.lane_next_k[lane] \
                        else self.t0 + self.traffic.lane_phase(lane)
                    if now < start:
                        continue
                    self.lane_free_at[lane] = start
                rec = self._open(lane, now)
            if self.mix["mode"] == "ahead":
                self._push(rec, min(rec.n_msgs, rec.processed() + lead))
            else:
                n = rec.pushed
                while n < rec.n_msgs and rec.due[n] <= now:
                    self.late.append(now - rec.due[n])
                    n += 1
                self._push(rec, n)

    def step(self, span: bool) -> dict:
        cur = {"start": time.perf_counter(), "frontend": 0.0, "submit": 0.0,
               "deliver": 0.0, "ticked": False}
        self._cur = cur
        self._mark("bench.frontend")
        self.svc.step()
        self._mark(None)
        cur["end"] = time.perf_counter()
        self._cur = None
        self.step_idx += 1
        if span and cur["ticked"]:
            self.spans["step"].append(cur["end"] - cur["start"])
            self.spans["frontend"].append(cur["frontend"])
            self.spans["dispatch"].append(cur["submit"] + cur["deliver"])
        return cur

    def loop_step(self, span: bool) -> dict:
        now = self.now()
        self._mark("bench.feed")
        self.feed(now)
        cur = self.step(span)
        if self.mix["mode"] == "open" and not cur["ticked"]:
            # the ticker's idle back-off
            time.sleep(0.002)
        return cur

    def drain(self, timeout: float) -> bool:
        """No more audio: step until every open call's generated user
        features are decided. False if that takes longer than timeout."""
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            open_recs = [r for r in self.lanes if r is not None]
            if all(len(r.decisions) >= r.features() for r in open_recs):
                break
            self.step(span=False)
        self.svc.drain_ticks()
        return all(len(r.decisions) >= r.features()
                   for r in self.lanes if r is not None)


# --------------------------------------------------------------------------
# launch records of the traced steps (pass-through wrappers)
# --------------------------------------------------------------------------

class Launches:
    """Records, while installed, the shapes of the port's kernel entries
    (K1/K5 projections, K2 attention) and of the LLM forwards and the
    encoder passes they belong to. Tensors are kept by reference and read
    once the traced steps are over."""

    def __init__(self):
        self.forwards: List[dict] = []
        self.frontends: List[tuple] = []
        self._undo = []

    def install(self):
        from freeze_omni_tpu_torch.models import audio_llm, qwen2

        rec = self

        def patch(mod, name, make):
            real = getattr(mod, name)
            setattr(mod, name, make(real))
            self._undo.append((mod, name, real))

        def fwd(real):
            def forward(params, cfg, embeds, mask, cache, *a, **k):
                rec.forwards.append({"mask": mask, "linear": [], "k2": []})
                return real(params, cfg, embeds, mask, cache, *a, **k)
            return forward

        def lin(real):
            def linear(p, x):
                if rec.forwards and ("w_q4" in p or "w_q" in p):
                    kind = "k5" if "w_q4" in p else "k1"
                    w = p["w_q4"] if kind == "k5" else p["w_q"]
                    K = x.shape[-1]
                    rec.forwards[-1]["linear"].append(
                        (kind, x.numel() // K, K, w.shape[-1]))
                return real(p, x)
            return linear

        def k2(real):
            def f(q, k_q, k_scale, v_q, v_scale, qend):
                if rec.forwards:
                    rec.forwards[-1]["k2"].append((tuple(q.shape), qend))
                return real(q, k_q, k_scale, v_q, v_scale, qend)
            return f

        def front(real):
            def f(params, cfg, identity, chunk, caches, active):
                rec.frontends.append((tuple(chunk.shape), active))
                return real(params, cfg, identity, chunk, caches, active)
            return f

        patch(qwen2, "forward", fwd)
        patch(qwen2, "prefill_quant", k2)
        patch(qwen2, "linear", lin)
        patch(audio_llm, "_frontend", front)

    def remove(self):
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)
        self._undo = []

    def resolve(self) -> dict:
        """Host numbers of everything recorded."""
        fwds = []
        for f in self.forwards:
            valid = int(f["mask"].sum())
            k2 = []
            for shape, qend in f["k2"]:
                qe = qend.cpu().numpy()
                k2.append((shape, [(b, [int(x) for x in row if x > 0])
                                   for b, row in enumerate(qe)]))
            fwds.append({"valid": valid, "linear": f["linear"], "k2": k2})
        fronts = [(shape, int(active.sum())) for shape, active in self.frontends]
        return {"forwards": fwds, "frontends": fronts}


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------

def _backlog(run: Run, now: float) -> float:
    """Mean over open calls of the user windows due (open loop) or sent
    (closed loop) and not yet fully processed."""
    recs = [r for r in run.lanes if r is not None]
    if not recs:
        return 0.0
    due = [sum(1 for d in r.due if d <= now) if r.due else r.pushed for r in recs]
    return float(np.mean([d - r.processed() for d, r in zip(due, recs)]))


def _cpu_ms() -> float:
    """The host CPU's speed as this process gets it: the fastest of five
    timings of a fixed pure-Python loop, in ms."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        x = 0
        for i in range(100_000):
            x += i * i
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def host_state() -> dict:
    """What the card and the host are doing beside a run: the card's SM
    clock (MHz), temperature (C), power draw (W) and active throttle
    reasons (nvidia-smi), the host CPU's speed (_cpu_ms) and this process's
    own CPU seconds."""
    out = {"t": time.perf_counter(), "cpu_ms": _cpu_ms()}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
                            "power.draw,clocks_throttle_reasons.active",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=10)
        out["card"] = (r.stdout if r.returncode == 0 else r.stderr).strip()[:200]
    except (OSError, subprocess.SubprocessError) as e:
        out["card"] = repr(e)[:200]
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["self_s"] = ru.ru_utime + ru.ru_stime
    return out


def host_delta(a: dict, b: dict) -> dict:
    """Between two host_state readings: the card and the host CPU's speed
    at both ends, and the CPU cores this process took on average."""
    return {"card": [a["card"], b["card"]], "cpu_ms": [a["cpu_ms"], b["cpu_ms"]],
            "self_cores": (b["self_s"] - a["self_s"]) / (b["t"] - a["t"])}


def _window_numbers(run: Run, snap: Dict[str, int], tw0: float, tw1: float) -> dict:
    msg_s = run.traffic.msg_s
    processed = 0
    lat = []
    for rec in run.calls:
        start = snap.get(rec.sid, 0)
        # processed by the window's end: what the decisions delivered by
        # then cover
        n = sum(1 for d in rec.decisions if d[2] <= tw1)
        cum = rec.feat_cum
        j = 0
        while j < len(cum) and cum[j] <= n:
            j += 1
        processed += max(j - start, 0)
        # decision k answers the k-th user feature, released by window j:
        # its latency runs from the due time of message j
        if rec.due:
            j = 0
            for k, d in enumerate(rec.decisions):
                while cum[j] <= k:
                    j += 1
                if tw0 <= d[2] <= tw1:
                    lat.append(d[2] - rec.due[j])
    return {"stream_rate": processed * msg_s / (tw1 - tw0), "latencies": lat}


def execute(cell: dict, conf: dict, mix: dict, seed: int, seconds: float,
            trace: bool, device, control: bool = False, log=print,
            steps: Optional[int] = None) -> dict:
    """Runs one cell once; returns the numbers the result line is made of.
    steps: a window of that many steps instead of `seconds` (the closed
    loop then serves the same schedule on every run; benchmark/witness.py)."""
    from . import trace as trace_mod

    clock = time.perf_counter
    t_setup = clock()
    cuda = torch.device(device).type == "cuda"
    bits = conf["precision"]["weight_bits"]
    ctrl = conf.get("control", {}) if control else {}
    if "weight_bits" in ctrl.get("program", {}):
        bits = ctrl["program"]["weight_bits"]
    if cuda:
        from freeze_omni_tpu_torch.ops import _build
        _build.build(["quant_matmul" if bits == 8 else "quant_matmul4",
                      "prefill_quant"])
    t_kernels = clock() - t_setup
    run = Run(conf, mix, seed, device, bits=bits)
    t_traffic = clock() - t_setup - t_kernels
    run.build()
    t_service = clock() - t_setup - t_kernels - t_traffic
    role = conf["role_prompt"]
    if run.cfg.duplex.default_prompt != role:
        raise SystemExit("the configuration's role prompt is not the served one")
    run.t0 = run.now()
    warm = int(mix["warmup_ticks"])
    ticks = 0
    probe = None
    warm_s = []
    virtual = mix["mode"] == "open"
    while ticks < warm:
        t = clock()
        if virtual:
            run.offset = clock() - (run.t0 + len(warm_s) * run.traffic.msg_s)
        if ticks == warm - 1 and trace and cuda:
            probe = _probe(run, cell)
            ticks += 1
        else:
            ticks += run.loop_step(span=False)["ticked"]
        warm_s.append(round(clock() - t, 3))
    if virtual:
        run.offset = clock() - (run.t0 + len(warm_s) * run.traffic.msg_s)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock() - t_setup
    log(f"[setup] kernels {t_kernels:.2f} s, traffic {t_traffic:.2f} s, "
        f"service {t_service:.2f} s, warm-up ticks and sessions "
        f"{setup_s - t_kernels - t_traffic - t_service:.2f} s (steps {warm_s})")

    # the measured window
    host0 = host_state()
    snap = {r.sid: r.processed() for r in run.calls}
    backlog0 = _backlog(run, run.now())
    tw0 = run.now()
    while (run.now() - tw0 < seconds) if steps is None else (run.step_idx < steps):
        run.loop_step(span=True)
    tw1 = run.now()
    host = host_delta(host0, host_state())
    win = _window_numbers(run, snap, tw0, tw1)
    win["backlog"] = (backlog0, _backlog(run, tw1))
    out = {"setup_s": setup_s, "window_s": tw1 - tw0, "win": win,
           "late": list(run.late),
           "steps": len(run.spans["step"]), "spans": run.spans, "probe": probe,
           "host": host}

    if trace:
        out["trace"], out["launches"] = _traced_steps(run, int(mix["trace_steps"]),
                                                      cuda, trace_mod)
    drained = run.drain(DRAIN_TIMEOUT_S)
    win["attempted"] = sum(r.user_submits for r in run.calls)
    win["failed"] = sum(max(r.user_submits - len(r.decisions), 0) for r in run.calls)
    out["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    # the reference sees only what the served run recorded: the program's
    # state is freed first
    sampled = [r for r in run.calls if r.sampled and r.submits]
    last_step = run.step_idx
    traffic, cfg = run.traffic, run.cfg
    del run.svc
    run.svc = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = clock()
    out["numbers"] = judge_calls(sampled, traffic, conf, cfg, last_step, seed,
                                 device, ctrl)
    log(f"[judge] {len(sampled)} calls, {clock() - t_judge:.1f} s")
    out["numbers"]["drained"] = drained
    out["lanes"] = len(run.sampled_lanes)
    return out


def _profiled(run: Run, n_ticks: int, cuda: bool, trace_mod):
    """n_ticks ticking steps under torch.profiler (device activity only),
    synchronised at both ends so the window holds all their device work.
    The traffic stays on its real-time clock; only the profiler's own
    start (seconds of it) is taken out of traffic time, so it leaves no
    backlog behind."""
    from torch.profiler import ProfilerActivity, profile

    run.recording, run.host_marks = True, []
    t = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA] if cuda else
                     [ProfilerActivity.CPU]) as prof:
            if cuda:
                torch.cuda.synchronize()
            run.offset += time.perf_counter() - t
            w0 = time.time_ns()
            ticks = 0
            while ticks < n_ticks:
                ticks += run.loop_step(span=False)["ticked"]
            run._mark(None)
            if cuda:
                torch.cuda.synchronize()
            w1 = time.time_ns()
    finally:
        run.recording = False
    if not cuda:
        return trace_mod.summarize([], [], 0.0, (w1 - w0) * 1e-9)
    return trace_mod.reduce(prof, run.host_marks, w0, w1)


def _probe(run: Run, cell: dict):
    """One warm-up tick under the profiler: every kernel family that a
    declared roofline reads must show up by its name."""
    from . import roofline, trace as trace_mod

    tr = _profiled(run, 1, True, trace_mod)
    fams = roofline.family_seconds(tr["device"])
    need = cell.get("kernels", [])
    missing = [k for k in need if fams.get(k, 0.0) <= 0.0]
    if missing:
        names = sorted({n for n, _, _ in tr["device"]})[:40]
        raise SystemExit(f"probe: no device time for kernel families {missing}; "
                         f"kernels seen: {names}")
    first = min((x[1] for x in tr["device"]), default=-1.0)
    return {"families_s": {k: fams.get(k, 0.0) for k in need},
            "window_s": tr["window_s"], "busy_s": tr["busy_s"],
            "first_op_s": first}


def _traced_steps(run: Run, n_ticks: int, cuda: bool, trace_mod):
    launches = Launches()
    launches.install()
    try:
        tr = _profiled(run, n_ticks, cuda, trace_mod)
    finally:
        launches.remove()
    return tr, launches.resolve()


def judge_calls(sampled, traffic, conf: dict, cfg, last_step: int, seed: int,
                device, ctrl: dict) -> dict:
    from . import judge
    from .reference import model as ref_model
    from .reference import tokens
    from .weights import Weights

    limits = conf["limits"]
    numbers, replays = judge.frontend_checks(sampled, traffic, conf, last_step,
                                             limits, low=bool(ctrl))
    if numbers["submit_mismatch"] and not ctrl:
        numbers.update({"state_gap": float("nan"), "missing": 0, "compared": 0})
        return numbers
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    ref_model.plain_mode()
    try:
        dims = conf["dims"]
        V = dims["llm"]["vocab_size"]
        weights = Weights(dims, seed, device)
        role = tokens.role_ids(conf["role_prompt"], V)
        prefix = tokens.prefix_ids(V)
        with torch.no_grad():
            states = judge.reference_states(sampled, replays, weights, dims,
                                            conf["precision"], role, prefix, device)
            served = None
            if "reference" in ctrl:
                low = dict(conf["precision"], **ctrl["reference"])
                served = judge.reference_states(sampled, replays, weights, dims,
                                                low, role, prefix, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
            prev_tf32
    numbers.update(judge.state_checks(sampled, states, served))
    return numbers
