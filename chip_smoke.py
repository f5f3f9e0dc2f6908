#!/usr/bin/env python3
"""Smoke test of the PyTorch port (freeze_omni_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Runs the port's serving paths on the card with no fallback anywhere: the
duplex dialog-state tick and the batched spoken response (text decode ->
speech decoder -> codec -> PCM) in int8, and the int4 configuration served
through bin/serve.py's Server and the DuplexService; then the native host
frontend, the training path, serving across ranks and training across
ranks with the ring-attention and pipelined forwards. Any failing phase raises and the script
exits nonzero without printing a result. Phases:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: every kernel of both paths from freeze_omni_tpu_torch/csrc with
   nvcc for sm_90a, one nvcc per source, all started together (ptxas
   register/spill report printed per kernel);
3. kernel parity, each kernel against its plain PyTorch version on the same
   inputs: K1 (int8 weight-only matmul, the mma.sync tile path at every N)
   at every projection shape for N in {1, 8, 17, 89, 232, 233, 1856}, the
   int8 lm_head at N in {8, 89} and a ragged O (520), with weights of -128
   and 127, bf16, rtol = atol = 2e-2; K5 (grouped int4 matmul) at every
   projection shape and the int4 lm_head's (3584 x 152064) for N in {1, 2,
   3, 5, 8, SMALL_N} (its split-K small-N path) and {17, 89, 232, 233,
   1856} (its tile path), group 64, and group 128 (K = 18944 among them), a
   ragged O (520) with 59 groups over the splits, bf16 at 2e-2 and f32
   with TF32 off at 1e-4, with a weight tile of nibble 0; both kernels must
   give bit-identical outputs from two calls and count one launch a call,
   and K5's small-path count must rise on exactly the N <= SMALL_N cases;
   K2 (int8-KV prefill attention, bf16: the split-S tensor-core kernel) at
   B=8, H=28, Hkv=4, dk=128 with a non-finite scale in slot S-1: T=29 with
   ragged qend including 0 at S in {1024, 2048}, the text step (T=1, qend
   = length + 1, one row at S-1), the tick's mask (8 of 29 tokens valid,
   one row's last at S-1, S=2048) and the role prefill (T=89: ten row
   tiles a (row, kv head), one split each),
   2e-2 on valid rows, masked rows zero, two calls bit-identical and one
   launch a call;
   K3 and K4 (float-cache decode attention) at the LLM shape B=8, H=28,
   Hkv=4, dk=128, S=1024 in bf16 (2e-2: one bf16 rounding of the output)
   and the speech decoder's shape B=8, H=Hkv=14, dk=64, S in {1265, 2048}
   in f32 with TF32 off (1e-4: f32 sums in another order), with lengths
   0, 1, 255, 256, 257 and S-1 among the rows, then K4's plan edges:
   the tiny speech decoder's head dim 32 (4 heads, f32, S=256; phase 11)
   and dk 32 with 16 query heads a kv head in bf16,
   first_response's 73..123 visible slots under one split and under 8
   splits (narrow heads: blocks past a row's tiles exit), the 32-slot tile
   edges under 4 splits, and the two mixed dtype pairs (bf16 q on an f32
   cache, f32 q on a bf16 cache); NaN in slot S-1 and in every slot past a
   row's length. Valid rows are compared; masked rows (qend = 0, length =
   0) must be zero; two calls bit-identical, one launch a call, and K4
   replayed from a CUDA graph equal to an eager call; K4 at the per-session
   path's two B = 1 shapes (the LLM's bf16 text decode, 28 / 4 heads of
   128, 32 splits; StreamingTTS's f32 decoder, 14 heads of 64, 9 splits; S
   2048) at lengths 0, 1, 31, 32, 33 and 2047 with NaN past each (bf16 to
   1e-3, f32 to 1e-4), and K1 at
   N = 1 on the lm_head and at the per-session chunks' N (12, 17) on every
   projection;
4. tick parity at full width and reduced depth: the flagship widths with 2
   LLM layers, int8 KV, and int8 weights, then int4 weights (as the server
   draws them); for each, the same weights and fbank windows
   through the engine on the card (kernels) and on the CPU (plain versions)
   for a few dual ticks; probabilities within 5e-3 (int8 KV re-quantization
   flips on 1-ulp activation differences), decisions at the 0.5 threshold
   and KV lengths identical. TF32 is off for this phase and the next;
5. response parity, card against CPU, on the engines of phase 4 with the
   flagship speech decoder and codec (seeded random weights), greedy text
   and codec sampling: respond_fast_many for both sessions, one
   continue_segments round, then one BatchedTTS sentence to its end (the
   sentence budget cut to 120 codec tokens). The card records every sampled
   token; the CPU replays them teacher-forced and checks at each draw that
   the card's token is its own argmax, or else that it loses to the argmax
   by at most 5% of the row's largest logit (a near-tie: with int8 weights
   the text activations are bf16, and random weights give near-ties that
   one bf16 rounding can flip). The BatchedTTS sentence gets the same
   inputs on both. PCM within 1e-3 (same codec tokens; ~30 stacked f32
   convolutions that cuDNN may compute with FFT or Winograd algorithms),
   continue hiddens within 5% of each row's largest magnitude (bf16), KV
   lengths equal;
6. the tick path at full width and depth: flagship_system() (Qwen2-7B
   widths, 28 layers) with int8 weights from the torch-side random init, a
   bf16 frontend, kv_quant_bits=8, max_kv_len=1024 and 8 sessions with the
   default role; full-duplex dual ticks from dev wavs through the
   GatingChunker, each tick gating that tick's audio chunk of all 16
   streams, until a KV roll has fired and at least 100 ticks ran. All
   launch counts are zeroed just before and read just after; K1 and K2 must
   be > 0. Prints tick p50/p90 (host frontend + engine.tick, and each alone)
   against the 224 ms budget and the peak device memory;
7. the response path at full width and depth, on the engine of phase 6
   (8 sessions with real dialog context) and the flagship speech decoder
   and codec (seeded random weights), as the duplex service drives it:
   respond_fast_many for all 8 sessions at once, then continue_segments
   rounds of 16 tokens up to 64 or eod, each round's sentences through
   split_sentences + post_process + engine.embed_tokens into a BatchedTTS
   pool of 8, stepped until every sentence has finished. Launch counts are
   zeroed just before and read just after; K1, K2 and K4 must be > 0. Every
   PCM chunk must be finite with |pcm| <= 1, and every session must get
   first-response audio and at least one pooled sentence;
8. kernel times with CUDA events at the paths' shapes, each beside its
   bound: max(bytes / 3.35 TB/s, operations / 989 TFLOP/s), counting each
   input byte once and, for K2-K4, only the cache slots this run makes
   visible; beside the plain version's time and, where one PyTorch call
   computes the same function, that call's time; K1 and K5 per projection
   and per layer, also as device time (calls captured in a CUDA graph) and
   beside a dense bf16 torch.matmul on weights dequantized before the timed
   window (dense_bf16_ms: a reference ceiling, not the same function, never
   on the port's path); K2 at the tick (T=29) and the text step (T=1) on
   the live layer-0 cache, eager and as device time, beside
   scaled_dot_product_attention on that cache dequantized to bf16 before
   the timed window with the qend mask (sdpa_bf16_ms: a reference ceiling,
   not the same function, never on the path); K3 and K4 on the live pool's
   layer-0 cache and at first_response's shape, eager, as device time and
   as device time with the cache cold in L2 (bin/k4_profile.time_decode),
   beside one scaled_dot_product_attention call with the length mask, and
   after phase 9 on its pool's layer-0 cache at the lengths of its deepest
   step; K5 is timed after phase 9
   on the int4 server's layer-0 projections, at N=232 and at N in {1, 4, 8,
   SMALL_N} (text decode), beside torch._weight_int4pack_mm on the same
   weights (each also as device time: calls captured in a CUDA graph and
   replayed, which leaves out the host's time per call), and both K5 paths
   are timed on the q and gate shapes at N in
   {1, 2, 4, 8, 12, 16, 24, 32}: the crossover that sets SMALL_N;
9. the int4 serving path at full width and depth (phases 6-8's engine
   freed first): the port's Server from get_args(SERVE_ARGV) (flagship,
   --engine --quant 4 --kv_quant 8, 8 sessions, --respond), its ticker
   stopped and its DuplexService stepped here. 8 sessions stream speech as
   users and a quiet line as the system, 224 ms per identity per step; once
   every user's first IPU has closed, one step at threshold 0 makes the
   sessions inside their next IPU speak, then the service runs their
   continuation rounds and pooled sentences until flush_tts finds the pool
   empty. Launch counts are zeroed just before and read just after, and
   read around every step: K5 and K2 must launch on the tick-only steps
   and K1 must not (every projection is int4; only the int8 lm_head uses
   K1), K1 and K4 must launch in the response, and K5's small-N path in
   the steps with response work (text decode). Every session must get user
   ipu_sl/ipu_el events and finite dialog_state_update probabilities, the
   response audio must be finite with |pcm| <= 1, and the system VAD must
   hear the fed-back audio. Prints the step p50/p90 against 224 ms (whole
   step, host frontend, VAD alone, engine.tick), each continuation round's
   time (resp_segment text-decode steps of the speaking sessions, where
   K5 runs its small-N path), the resident LLM weight
   bytes int4 beside int8, the peak memory and the launches;
10. the per-session path (phase 9's server freed first): (a) card against
   CPU at flagship width with 2 LLM layers, int8 weights and the bf16 float
   KV: DuplexPipeline over user (ipu_sl, ipu_cl) and system chunks,
   probabilities within 5e-3, KV lengths and pe_index equal, then
   DuplexResponder's first 8 text draws teacher-forced on the CPU (the
   phase-5 near-tie rule); (b) full depth: the port's Server from
   get_args(SESSION_ARGV) (flagship, --respond, no --engine) and two
   DuplexSessions on its pipeline, each on its own worker thread
   (Server._open_session, as the websocket handler opens them). Users
   stream phase 9's surrogate in real time (a 224 ms chunk every 224 ms),
   the system line -66 dBFS noise plus the fed-back speech; each session's first decision after its first user
   IPU closed runs at threshold 0 and speaks a fixed sentence (random-
   weight text decodes to nothing) with the response's hiddens as prefix,
   through the responder's own synthesis step (StreamingTTS, max_tokens
   cut to 200). Launch counts are zeroed just before and read just after:
   K1 and K4 must launch, K4 from both the text decode and StreamingTTS
   (counted by caller), K2, K3 and K5 must not. The role prefill must be
   unchanged after the sessions and a reset_context; every user gets
   ipu_sl/ipu_el and finite probabilities; the PCM is finite within
   [-1, 1] and the system VAD hears the feedback. Prints _predict_stage per
   chunk p50/p90 against 224 ms, dialog_ss to the first response_audio,
   the peak memory and the launches; then, on the same pipeline with one
   caller, a user chunk and a text-decode step, and the device's busy
   share of 4 profiled chunks (torch.profiler); then K1 (N = 1 with the
   lm_head, the chunks' N) and K4 (both B = 1 shapes, at the run's last
   lengths) are timed as in phase 8;
11. checkpoints, the offline CLI and the eval harnesses (phase 10's server
   freed first): (a) the committed trained tiny system, read by
   utils/factory.load_native_system from freeze_omni_tpu_torch/assets/
   tiny_s2s (chunks.json: each array taken from the JAX package's orbax
   zstd chunks by its sha256, with libzstd) with TF32 off: bin/asr_eval.main (--char_level
   --batch 8 --max_tokens 24) on asr_dev.tsv and bin/qa_eval.main (--batch
   8 --max_tokens 12) on qa_dev.tsv, QUALITY.json's flags; CER must be <=
   3.74 % and QA >= 93.75 % (QUALITY.json: 2.74 / 100.0); K4 must launch
   (the text decode); then one batch of 8 ASR utterances through
   batched_transcribe on the card and on the CPU (every differing
   hypothesis printed) and the serial transcribe on 2; (b) the offline CLI,
   offline_infer.run_inference on dev_wavs/qa_000.wav with greedy text
   and speech sampling (decoder_topk 1), its text identical to the same call on the CPU, the PCM
   finite, span_report printed; K4 timed as in phase 8 at the tiny
   StreamingTTS's shape (head dim 32, 40 visible slots), beside its bound,
   its plain version and scaled_dot_product_attention; (c) a
   reference-format checkpoint at
   Qwen2-7B width (audiollm/{train.yaml, final.pt, global_cmvn},
   decoder/{model.json, final.pt}, codec/{model.json, final.pt} and an HF
   dir of config.json + a bf16 model.safetensors from this script's minimal
   writer; 2 LLM layers, the depth cut to stay in the run's limit; seeded
   random weights) in a temporary directory, deleted after: loaded with
   build_system_from_reference(quantize_llm_bits=8) onto the card (the LLM
   config must be the HF config.json's, the q projection int8 on the card),
   one run_inference turn, then bin/serve's Server(get_args(["--model_path",
   ..., "--llm_path", ...])) and one DuplexSession on its pipeline: a reset,
   then user speech until two dialog_state_update events. Launch counts
   are zeroed before and read after; K1 and K4 must be > 0. Prints the load
   time and the peak memory;
12. voice prompts, the LoRA merge, serving snapshots and the last serving
   CLIs (phase 11's systems freed first; prints its wall time): (a) a
   rank-16 adapter on all 7 targets (B drawn non-zero) merged with
   models/lora.merge into int8 and int4 trees at Qwen2-7B widths with 2 LLM
   layers, on the card and on the CPU: merged scales within one f32 ulp,
   codes equal where the scales are and within one elsewhere, other leaves
   within 1e-6; then phase 4's tick parity on the merged weights (4 ticks,
   5e-3, decisions and KV lengths equal); (b) Server(get_args(SERVE_ARGV +
   [--lora <adapter.npz>, --voice_wav dev_wavs/asr_000.wav, --state_dir
   <tmp>])) at full depth, TF32 off for its f32 voice encoder: the merge
   time over 28 layers x 7 targets and the peak memory; the voice's global
   tokens, card against the same call on the CPU (equal, or a near-tie:
   the card's codeword within 1e-5 relative of the CPU's least distance);
   8 sessions, 10 dual ticks on fixed dev-wav fbank windows (as phase 6
   feeds them), Server.snapshot (the bytes and seconds), 10 more ticks
   recorded; the server freed, a second one with the same flags,
   Server.restore_snapshot (the seconds), the clients reattach (KV lengths
   as saved) and the 10 ticks are replayed: probabilities within 1e-3 of
   the recorded run, decisions and KV lengths equal, K5 and K2 launched;
   then user speech until half the users are inside an IPU and one step at
   threshold 0: the sessions that speak get finite PCM within [-1, 1], K1
   (the int8 lm_head) and K4 launch; one fixed sentence through a BatchedTTS
   pool, greedy, in the voice, again, and in the default voice: the voice's
   PCM differs from the default's by more than ten times the repeat's
   difference; (c) bin/codec_tool.main on that dev wav at the flagship codec
   (seeded random weights with the encoder branch): code shapes, a finite
   reconstruction; (d) bin/out_cer_eval.main on the trained tiny system
   (the port's copy) at --top_k 1 on sentences.txt, on the card and on the
   CPU, TF32 off: both out-CERs beside QUALITY.json's, every differing
   hypothesis printed (the ASR pass samples at the config's top-k with each
   device's generator), K4 launched;
13. the native host frontend (frontend/native.py over native/frontend/
   {fbank,resample,vad}.cc, built with g++ on this host; phase 9 already
   asserts its service frontends took it): the native fbank at 25/10 and
   16/8 ms against fbank_ref, the offline and gating chunkers against their
   torch paths (rtol 1e-4, atol 1e-3), the one-shot and streaming
   resamplers against the numpy path (1e-6), the learned VAD against its
   numpy GRU (2e-3, statuses equal); then phase 9's frontend work (8
   sessions x 2 identities, VAD + gating a 224 ms chunk) timed with the
   native core and with the numpy/torch paths in turns (numpy, native,
   native, numpy), beside phase 9's service-step host frontend; prints its
   wall time;
14. training, launch counts zeroed before and read after (no kernel may
   launch: the frozen LLM is f32): (a) one stage_step of state, align, lora
   and all at Qwen2-7B width with 2 LLM layers, TF32 off, card against CPU
   from the same weights and data.py batch: loss within 1e-4 relative,
   every gradient within 1e-3 of its leaf's largest entry, parameters after
   the step within 1e-5 where the gradient is resolved (above 1e-3 of the
   tree's largest) and within 2 lr elsewhere (the first Adam step moves an
   entry by about lr * sign(g)); (b) bin/train.run --preset flagship
   --stage state --steps 6 --batch 2 --save_every 3 (full width and
   depth, the f32 LLM), then 3 steps and --resume for 3 more: the resumed
   losses within 1e-5 relative of the uninterrupted ones; s/step, the peak
   memory and the losses printed; (c) --stage lora (rank 8, q,v) for 3
   steps, its lora.npz merged by serve's _merge_lora into an int4 Qwen2-7B
   tree as the --quant 4 server draws it: layer 0's weight change regressed
   on the adapter's delta must have slope 0.7-1.3; (d) three gan_steps at
   the flagship codec (autoencode with the VQ losses, 2 x 0.5 s of speech
   surrogate) and a dead-code reseed, then training/vad.train for 3 steps
   of 8 mixtures: finite losses. Prints its wall time;
15. multi-GPU serving (parallel/, runtime/multihost_serving.py), its ranks
   processes of this script (`--tp-rank <job.json>`) met at a free
   localhost port: NCCL with a card each where the host has a card for
   every rank, else gloo with the ranks sharing the card (printed with the
   card count; no step time of ranks sharing a card is a TP speed). (a)
   two ranks at tp = 2, Qwen2-7B widths cut to 2 LLM layers, int8 then
   int4, phase 4's dual ticks against one rank on the card: |dprob| <=
   2e-3, decisions (off the threshold's 2e-3 band) and KV lengths equal,
   both ranks' predictions identical; (b) phase 9's traffic at full width
   and depth, --quant 4 --kv_quant 8, 8 sessions, through
   DuplexService(engine=PrimaryDriver(...)) on rank 0 and run_follower on
   rank 1 at tp = 2; (c) the same over (data 2, model 1), two "hosts"
   joined as serve --coordinator joins them. Each rank zeroes its launch
   counts before the traffic and reads them after: K2 and K5 must launch on
   every rank, K1, K4 and K5's small-N path on every rank whose rows hold
   a speaking session; each rank's peak memory and the step p50/p90
   printed; (d) K1 and K5 on one layer's 7 projections at N = 232 and
   N = 8 (K1 with the int8 lm_head) and K2 at T = 29 and T = 1, at the
   shapes one rank of tp = 2 and of tp = 4 runs, each beside its bound, its
   plain version and the library call (phase 8's timers). Prints its wall
   time;
16. multi-GPU training and the long-sequence forwards (bin/train.py's
   data-parallel mode, parallel/ring_attention.py, parallel/
   pipeline_parallel.py), ranks as in phase 15: (a) bin/train.run over two
   ranks joined as two "hosts" (2 rows each of a batch of 4) at Qwen2-7B
   widths, the LLM cut to 20 layers where the two ranks' f32 trees share
   one card (28 with a card each), --stage state and all, AdamW at lr
   5e-6, against one rank on the whole batch (in this process: run()
   starts no process), after one step and after four: every loss within
   1e-5 relative, the parameters within phase 14's rule (1e-5 where the
   gradient is resolved, 2 lr elsewhere), after one step the gradients
   within phase 14's rule, the ranks' checksums equal, and a resume on both ranks from
   the four-step run's step-3 checkpoint equal to its step 4; each rank's
   s/step and peak printed; no kernel may launch; (b) where the host has two or more cards,
   `python -m freeze_omni_tpu_torch.bin.train --preset flagship --stage
   state` at full depth over them, one rank a card (else one line says why
   not); (c) sp_forward at Qwen2-7B width and depth, B = 1, T = 4096, bf16
   embeddings from the tree's table, int8 then int4 weights, at R = 4 (a
   ('seq',) mesh) and R = 2 (data index 0 of a (data 2, seq 2) mesh; data
   index 1 waits), against the unsharded causal forward
   (qwen2.train_forward) on one rank: every hidden row within 5e-2 of its
   largest entry; each rank launches K1 (int8) or K5's tile path (int4)
   exactly 7 x 28 times a forward and nothing else; each rank's peak
   memory against the unsharded run's, the time of a forward; (d)
   pp_forward over 4 stages (7 layers a rank, each rank holding only its
   stage_tree) with 4 microbatches of b = 1, T = 512, same weights and
   checks, 7 x 7 x 4 launches a rank, each rank's resident and peak memory;
   (e) K1 and K5's tile path on one layer's 7 projections at N = 2048 (a
   ring rank at R = 2) and N = 512 (a microbatch), each beside its bound,
   its plain version, the library call and a dense bf16 matmul (phase 3
   holds both kernels to their plain versions at N = 512, 1024 and 2048).
   Prints its wall time.

The last lines: the nvidia-smi line, one {"kernels": [...]} JSON line and
the device JSON line.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

BUDGET_MS = 224.0              # one gating chunk of audio
TTS_MAX_TOKENS = 200           # codec tokens per pooled sentence (default 1000)
PARITY_TTS_MAX_TOKENS = 120
TIE_FRAC = 0.05                # near-tie margin of the teacher-forced replay
PCM_TOL = 1e-3
HIDDEN_ROW_TOL = 0.05


def log(*a):
    print(*a, flush=True)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def max_violation(out, ref, tol, rtol=None):
    """max |out - ref| and whether every element is within tol + rtol*|ref|
    (rtol defaults to tol)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    rtol = tol if rtol is None else rtol
    return float(err.max()), bool((err <= tol + rtol * ref.abs()).all())


def pct(a):
    import numpy as np

    return f"p50 {np.percentile(a, 50):.2f} ms, p90 {np.percentile(a, 90):.2f} ms"


def kernel_wrappers():
    from freeze_omni_tpu_torch.ops import attention as att
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    return {"quant_matmul": qm.quant_matmul, "quant_matmul4": qm.quant_matmul4,
            "prefill_quant": att.prefill_quant,
            "decode_attention": att.decode_attention,
            "decode_attention_blocked": att.decode_attention_blocked}


def zero_launches():
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    for fn in kernel_wrappers().values():
        fn.launches = 0
    qm.quant_matmul4.launches_small = 0


def read_launches():
    """Launches of each kernel, and of K5's small-N path alone
    ("quant_matmul4_small", counted in "quant_matmul4" too)."""
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    out = {name: fn.launches for name, fn in kernel_wrappers().items()}
    out["quant_matmul4_small"] = qm.quant_matmul4.launches_small
    return out


def fixed_sentences():
    """The committed tiny system's sentences: the text of every synthesized
    sentence (random-weight text ids are almost all >= 256, which the byte
    tokenizer drops, so their own text would be empty)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "freeze_omni_tpu", "assets", "tiny_s2s", "sentences.txt")
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def tts_params(cfg, seed):
    """Flagship speech decoder + codec (decode half), seeded random f32
    weights drawn on the card."""
    import torch

    from freeze_omni_tpu_torch.models import codec
    from freeze_omni_tpu_torch.models import speech_decoder as sd

    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"decoder": sd.init_params(cfg.tts.decoder, g, device="cuda"),
            "codec": codec.init_params(cfg.tts.codec, g, device="cuda")}


def sentence_inputs(engine, text, hids):
    """A sentence's speech-decoder inputs as the service builds them
    (service._prepare_sentence): post_process'd text -> ids -> LLM
    embeddings folded to the decoder width, and the sentence's own text
    hiddens folded the same way as the prefix."""
    import numpy as np

    from freeze_omni_tpu_torch.pipeline import post_process

    idim = engine.cfg.tts.decoder.idim
    ids = engine.core.tokenizer.encode(post_process(text))
    hidden = engine.embed_tokens(ids).reshape(-1, idim)[None]
    prefix = np.concatenate(hids, axis=1).astype(np.float32).reshape(-1, idim)[None]
    return hidden, prefix


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


class SamplingTape:
    """Every token the response path samples, in call order. Attached with
    replay=False (on the card) it records the sampler's draws; attached with
    replay=True (on the CPU) it feeds the recorded tokens back instead of
    sampling (teacher forcing) and checks each against the CPU's own argmax:
    equal, or a near-tie within TIE_FRAC of the row's largest |logit|."""

    def __init__(self):
        self.tokens = []
        self.pos = 0
        self.stats = {k: {"draws": 0, "flips": 0, "worst_gap": 0.0}
                      for k in ("text", "codec")}

    @contextlib.contextmanager
    def attached(self, replay: bool):
        from freeze_omni_tpu_torch.models import audio_llm
        from freeze_omni_tpu_torch.models import speech_decoder as sd

        saved = (audio_llm._sample, sd.sample_top_k)
        audio_llm._sample = self._wrap("text", saved[0], replay)
        sd.sample_top_k = self._wrap("codec", saved[1], replay)
        try:
            yield self
        finally:
            audio_llm._sample, sd.sample_top_k = saved

    def _wrap(self, kind, sample, replay):
        import torch

        def record(gen, logits, arg):
            tok = sample(gen, logits, arg)
            self.tokens.append((kind, tok.cpu()))
            return tok

        def force(gen, logits, arg):
            want_kind, want = self.tokens[self.pos]
            self.pos += 1
            if want_kind != kind or want.shape[0] != logits.shape[0]:
                raise AssertionError(f"draw {self.pos}: the CPU samples {kind} "
                                     f"where the card sampled {want_kind}")
            lg = logits.float()
            rows = torch.arange(lg.shape[0])
            mine = lg.argmax(-1)
            gap = (lg[rows, mine] - lg[rows, want.long()]) / lg.abs().amax(-1)
            flips = mine != want.long()
            st = self.stats[kind]
            st["draws"] += int(rows.numel())
            st["flips"] += int(flips.sum())
            if flips.any():
                worst = float(gap[flips].max())
                st["worst_gap"] = max(st["worst_gap"], worst)
                if worst > TIE_FRAC:
                    raise AssertionError(
                        f"{kind} draw {self.pos}: card token {want.tolist()} vs "
                        f"cpu argmax {mine.tolist()}, gap {worst:.3e} of the "
                        f"largest logit (near-tie margin {TIE_FRAC})")
            return want.to(torch.int32)

        return force if replay else record


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
        for fn, spill, regs in ptxas_report(v["ptxas"]):
            log(f"[build]   {fn}: {spill}; {regs}")


def ptxas_report(text):
    """(kernel, spill line, register line) for every function in nvcc's
    -Xptxas -v output, the kernel's name demangled where c++filt exists."""
    import re
    import shutil

    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            rows.append([fn, spill, line.split(":", 1)[-1].strip()])
            fn = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, n in zip(rows, names):
            n = n.replace("(anonymous namespace)::", "")
            r[0] = re.sub(r"\(.*\)$", "", n.replace("void ", "", 1))
    return [tuple(r) for r in rows]


K1_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
TILE_NS = (17, 89, 232, 233, 1856)   # the tile path's N in phase 3
# N of the sharded engines' projections (phase 15): a text step's padded
# rows, the role prefill's 89 tokens, a tick of 8 sessions' 29 tokens at
# data 1 and of 4 at data 2
SHARD_NS = (1, 4, 8, 89, 116, 232)
# N of phase 16's projections: a pipeline microbatch (b = 1 of 512 tokens)
# and a ring rank's slice of 4096 tokens at R = 4 and R = 2
SP_PP_ROWS = (512, 1024, 2048)


def shard_shapes():
    """(tp, K, O) of one rank's q, k/v, o, gate/up, down and lm_head at
    tp = 2 and 4 of the flagship (parallel/mesh: q, k/v, gate/up and the
    lm_head cut on O, o and down on K)."""
    from freeze_omni_tpu_torch.config import flagship_system

    llm = flagship_system().audio_llm.llm
    D, hdk = llm.hidden, llm.num_heads * llm.head_dim
    kv = llm.num_kv_heads * llm.head_dim
    return [(tp, K, O) for tp in TP_SHARD_WAYS
            for K, O in ((D, hdk // tp), (D, kv // tp), (hdk // tp, D),
                         (D, llm.ffn // tp), (llm.ffn // tp, D),
                         (D, llm.vocab_size // tp))]


def session_chunk_ns():
    """N of the per-session path's chunk prefills at flagship: a 224 ms
    window's adapter tokens after the chat prefix of each identity (the
    prefix rows run masked on ipu_cl too)."""
    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models.audio_llm import chunk_tokens
    from freeze_omni_tpu_torch.utils.tokenizer import ByteTokenizer, ChatTemplate

    cfg = flagship_system()
    chat = ChatTemplate(ByteTokenizer(cfg.audio_llm.llm.vocab_size))
    t = chunk_tokens(cfg.duplex.gating.frames_per_step)
    return tuple(sorted({len(chat.user_prefix_ids) + t,
                         len(chat.system_prefix_ids) + t}))


def k1_inputs(N, K, O, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (K, O), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = (torch.rand(O, generator=g, device="cuda") + 0.5) / (127.0 * K ** 0.5)
    return x, w_q, scale


K5_SHAPES = K1_SHAPES + ((3584, 152064),)   # + the int4 lm_head (quantize_llm_params)


def k5_inputs(N, K, O, group, dtype, seed):
    """Packed bytes over all of 0..255 (both nibbles take every value) and a
    first tile of nibble-0 bytes (weight -8, which the quantizer never
    writes but the kernel must compute)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, K), generator=g, device="cuda").to(dtype)
    w_q4 = torch.randint(0, 256, (K // 2, O), generator=g, device="cuda",
                         dtype=torch.uint8)
    w_q4[:32, :128] = 0
    scale4 = (torch.rand((K // group, O), generator=g, device="cuda") + 0.5) \
        / (7.0 * K ** 0.5)
    return x, w_q4, scale4


# K2's phase-3 cases: (label, B, T, S, qend kind)
K2_CASES = (("ragged", 8, 29, 1024, "ragged"), ("ragged", 8, 29, 2048, "ragged"),
            ("text step", 8, 1, 1024, "text"), ("tick mask", 8, 29, 2048, "tick"),
            ("role prefill", 8, 89, 1024, "prefill"))
TICK_VALID = (8, 9, 10, 11, 25, 26, 27, 28)   # a dual tick's valid tokens of 29


def k2_inputs(B, T, H, Hkv, dk, S, seed, qend_kind="ragged"):
    """bf16 q against a random int8 cache with a non-finite scale in slot
    S-1. qend: "ragged" (row lengths in [S/8, S-T-1), 30% of the tokens
    masked, the last row all masked), "text" (T = 1, length + 1, one row
    at S-1), "tick" (TICK_VALID see length + rank + 1, the rest masked;
    the first row's last token at S-1) or "prefill" (every token valid)."""
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
    if qend_kind == "ragged":
        qend = torch.where(torch.rand((B, T), generator=g, device=dev) < 0.3,
                           torch.zeros_like(qend), qend)
        qend[-1] = 0
    elif qend_kind == "text":
        lengths[0] = S - 2
        qend = (lengths + 1)[:, None]
    elif qend_kind == "tick":
        lengths[0] = S - 1 - len(TICK_VALID)
        qend = torch.zeros((B, T), dtype=torch.long, device=dev)
        for rank, t in enumerate(TICK_VALID):
            qend[:, t] = lengths + rank + 1
    k_s[:, S - 1] = float("nan")   # the scratch slot may hold anything
    v_s[:, S - 1] = float("inf")
    return q, k_q, k_s, v_q, v_s, qend.to(torch.int32)


def decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype, seed, lengths=None):
    """K3/K4 inputs: lengths 0, 1, 255, 256, 257 and S-1 among the rows, the
    rest random (or `lengths`); NaN in slot S-1 and in every slot past a
    row's length."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((B, H, dk), generator=g, device=dev).to(q_dtype)
    k = torch.randn((B, S, Hkv, dk), generator=g, device=dev).to(kv_dtype)
    v = torch.randn((B, S, Hkv, dk), generator=g, device=dev).to(kv_dtype)
    special = [0, 1, 255, 256, 257, S - 1] if lengths is None else list(lengths)
    rest = torch.randint(1, S - 1, (B - len(special),), generator=g, device=dev)
    length = torch.cat([torch.tensor(special, device=dev), rest]).to(torch.int32)
    masked = torch.arange(S, device=dev)[None, :] >= length[:, None].long()
    k[masked] = float("nan")
    v[masked] = float("nan")
    k[:, S - 1] = float("nan")
    v[:, S - 1] = float("nan")
    return q, k, v, length


FIRST_RESPONSE_LENGTHS = [73, 80, 87, 94, 102, 109, 116, 123]
# K3/K4's phase-3 cases: (label, B, H, Hkv, dk, S, q dtype, cache dtype,
# lengths or None for 0, 1, 255, 256, 257, S-1 and random)
DECODE_CASES = (
    ("LLM text decode", 8, 28, 4, 128, 1024, "bfloat16", "bfloat16", None),
    ("BatchedTTS pool", 8, 14, 14, 64, 1265, "float32", "float32", None),
    ("first_response", 8, 14, 14, 64, 2048, "float32", "float32", None),
    ("first_response lengths", 8, 14, 14, 64, 2048, "float32", "float32",
     FIRST_RESPONSE_LENGTHS),
    ("short rows, 8 splits", 8, 2, 2, 64, 2048, "float32", "float32",
     FIRST_RESPONSE_LENGTHS),
    ("tile edges, 4 splits", 8, 4, 4, 64, 465, "float32", "float32",
     [0, 1, 31, 32, 33, 64, 309, 464]),
    ("bf16 q, f32 cache", 4, 28, 4, 128, 700, "bfloat16", "float32", [699, 0, 97, 1]),
    ("f32 q, bf16 cache", 4, 14, 14, 64, 700, "float32", "bfloat16", [699, 0, 97, 1]),
    ("tiny speech decoder, dk 32", 8, 4, 4, 32, 256, "float32", "float32",
     [0, 1, 31, 32, 33, 64, 200, 255]),
    ("dk 32, 16 heads a kv head", 4, 16, 1, 32, 700, "bfloat16", "bfloat16",
     [699, 0, 97, 1]),
)
# K4 at B = 1, the per-session path: (label, H, Hkv, dk, S, q/cache dtype)
SESSION_DECODE = (("session LLM text decode", 28, 4, 128, 2048, "bfloat16"),
                  ("session StreamingTTS", 14, 14, 64, 2048, "float32"))
SESSION_LENGTHS = (0, 1, 31, 32, 33, 2047)


def graph_equals_eager(fn, args):
    """fn(*args) captured in a CUDA graph (after warm-up calls on the
    capture stream) and replayed gives the eager call's bits."""
    import torch

    from freeze_omni_tpu_torch.ops import _build

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, fn(*args))
    del graph
    _build.release_workspace(torch.cuda.current_device(), stream.cuda_stream)
    return same


def phase_kernel_parity():
    import torch

    t0 = time.perf_counter()
    from freeze_omni_tpu_torch.ops import attention as att
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-2
    k1_err = 0.0
    k1_cases = [(K, O, N) for (K, O) in K1_SHAPES
                for N in sorted({1, 8, *TILE_NS, *session_chunk_ns()})]
    k1_cases += [(3584, 152064, N) for N in (1, 8, 89)]   # the int8 lm_head
    k1_cases += [(3776, 520, N) for N in (17, 232)]    # ragged O
    k1_cases += [(K, O, N) for (_, K, O) in shard_shapes() for N in SHARD_NS]
    k1_cases += [(K, O, N) for (K, O) in K1_SHAPES for N in SP_PP_ROWS]
    for (K, O, N) in k1_cases:
        x, w_q, scale = k1_inputs(N, K, O, seed=N + K + O)
        w_q[:16, :64] = -128   # the ends of int8, -128 beyond the quantizer's
        w_q[16:32, :64] = 127
        before = qm.quant_matmul.launches
        y = qm.quant_matmul(x, w_q, scale)
        y2 = qm.quant_matmul(x, w_q, scale)
        ref = qm.quant_matmul_reference(x, w_q, scale)
        torch.cuda.synchronize()
        if qm.quant_matmul.launches - before != 2:
            raise AssertionError(f"K1 at N={N} K={K} O={O}: launch count rose by "
                                 f"{qm.quant_matmul.launches - before}, not 2")
        if not torch.equal(y, y2):
            raise AssertionError(f"K1 gave two results for one input at N={N} "
                                 f"K={K} O={O}")
        err, ok = max_violation(y, ref, tol)
        k1_err = max(k1_err, err)
        log(f"[parity] K1 N={N} K={K} O={O} splits={qm.tile_plan(N, K, O)[2]}: "
            f"max_abs_err {err:.3e}; two calls bit-identical")
        if not ok or not torch.isfinite(y.float()).all():
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"N={N} K={K} O={O}: {err}")
        del x, w_q, scale, y, y2, ref
    k5_err = {"small": 0.0, "tile": 0.0}
    small_ns = (1, 2, 3, 5, 8, qm.SMALL_N)
    cases = [(K, O, N, 64) for (K, O) in K5_SHAPES for N in small_ns + TILE_NS]
    cases += [(3584, 3584, N, 128) for N in (8, qm.SMALL_N, 17, 232)]  # coarser group
    cases += [(18944, 3584, 232, 128)]   # K = 18944 split in whole groups of 128
    cases += [(3776, 520, N, 64) for N in (5, 17, 232)]   # ragged O, 59 groups
    # the shard shapes (o at tp = 4: K = 896, 14 groups)
    cases += [(K, O, N, 64) for (_, K, O) in shard_shapes()
              for N in sorted({*SHARD_NS, qm.SMALL_N})]
    cases += [(K, O, N, 64) for (K, O) in K1_SHAPES for N in SP_PP_ROWS]
    for (K, O, N, group) in cases:
        for dtype, dtol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            x, w_q4, scale4 = k5_inputs(N, K, O, group, dtype, seed=N + K + O)
            small = qm.quant_matmul4.launches_small
            total = qm.quant_matmul4.launches
            y = qm.quant_matmul4(x, w_q4, scale4, group)
            y2 = qm.quant_matmul4(x, w_q4, scale4, group)
            ref = qm.quant_matmul4_reference(x, w_q4, scale4, group)
            torch.cuda.synchronize()
            path = "small" if N <= qm.SMALL_N else "tile"
            if qm.quant_matmul4.launches_small - small != 2 * (path == "small") \
                    or qm.quant_matmul4.launches - total != 2:
                raise AssertionError(f"K5 at N={N} did not take its {path} path "
                                     f"once a call")
            if not torch.equal(y, y2):
                raise AssertionError(f"K5 ({path}) gave two results for one "
                                     f"input at N={N} K={K} O={O}")
            err, ok = max_violation(y, ref, dtol)
            if dtype == torch.bfloat16:
                k5_err[path] = max(k5_err[path], err)
            log(f"[parity] K5 {path} N={N} K={K} O={O} group={group} "
                f"{str(dtype).split('.')[-1]}: max_abs_err {err:.3e} (tol {dtol}); "
                f"two calls bit-identical")
            if not ok or not torch.isfinite(y.float()).all():
                raise AssertionError(f"K5 disagrees with its plain version at "
                                     f"N={N} K={K} O={O} group={group} {dtype}: "
                                     f"{err}")
            del x, w_q4, scale4, y, y2, ref
    k2_err = 0.0
    # one card's heads, then one rank's at tp = 2 and 4 (7 query heads on
    # one kv head)
    k2_heads = [(28, 4)] + [(28 // tp, 4 // tp) for tp in TP_SHARD_WAYS]
    for (label, B, T, S, qend_kind), (H, Hkv) in itertools.product(K2_CASES,
                                                                   k2_heads):
        q, k_q, k_s, v_q, v_s, qend = k2_inputs(B, T, H, Hkv, 128, S, seed=S,
                                                qend_kind=qend_kind)
        before = att.prefill_quant.launches
        out = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
        out2 = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
        ref = att.prefill_quant_reference(q, k_q, k_s, v_q, v_s, qend)
        torch.cuda.synchronize()
        valid = qend > 0
        if att.prefill_quant.launches - before != 2:
            raise AssertionError(f"K2 {label} H={H} Hkv={Hkv}: launch count rose by "
                                 f"{att.prefill_quant.launches - before}, not 2")
        if not torch.equal(out, out2):
            raise AssertionError(f"K2 gave two results for one input ({label}, "
                                 f"H={H} Hkv={Hkv})")
        if not torch.isfinite(out.float()).all() or (out[~valid] != 0).any():
            raise AssertionError(f"K2 wrote non-finite values or a nonzero "
                                 f"masked row ({label}, H={H} Hkv={Hkv})")
        err, ok = max_violation(out[valid], ref[valid], tol)
        k2_err = max(k2_err, err)
        plan = att.prefill_plan(B, T, H, Hkv, 128, S)
        log(f"[parity] K2 {label} B={B} T={T} H={H} Hkv={Hkv} dk=128 S={S} (rows "
            f"{plan.rows}, splits {plan.splits}): max_abs_err {err:.3e} on "
            f"{int(valid.sum())} valid rows; qend=0 rows zero; two calls "
            f"bit-identical")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version ({label}, "
                                 f"H={H} Hkv={Hkv})")
    dec_err = {"decode_attention": 0.0, "decode_attention_blocked": 0.0}
    for (label, B, H, Hkv, dk, S, q_dt, kv_dt, lengths) in DECODE_CASES:
        q_dtype, kv_dtype = getattr(torch, q_dt), getattr(torch, kv_dt)
        # bf16: one rounding of the output (2^-7 relative) and 1e-3; at
        # length 699 a dropped split or a wrong score moves an output by
        # ~1e-2, which a looser bound could pass
        dtol, drtol = (1e-3, 2 ** -7) if q_dtype == torch.bfloat16 else (1e-4, 1e-4)
        q, k, v, length = decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype,
                                        seed=S + dk, lengths=lengths)
        ref = att.decode_attention_reference(q, k, v, length)
        valid = length > 0
        splits = att.decode_plan(B, H, Hkv, dk, S).splits
        for name in dec_err:
            fn = getattr(att, name)
            before = fn.launches
            out = fn(q, k, v, length)
            out2 = fn(q, k, v, length)
            torch.cuda.synchronize()
            if fn.launches - before != 2:
                raise AssertionError(f"{name} ({label}): launch count rose by "
                                     f"{fn.launches - before}, not 2")
            if not torch.equal(out, out2):
                raise AssertionError(f"{name} gave two results for one input ({label})")
            if not torch.isfinite(out.float()).all() or (out[~valid] != 0).any():
                raise AssertionError(f"{name} wrote non-finite values or a "
                                     f"nonzero masked row ({label})")
            err, ok = max_violation(out[valid], ref[valid], dtol, drtol)
            dec_err[name] = max(dec_err[name], err)
            log(f"[parity] {name} {label} B={B} H={H} Hkv={Hkv} dk={dk} S={S} "
                f"{q_dt} q, {kv_dt} cache, K4 splits {splits}: max_abs_err "
                f"{err:.3e} (atol {dtol}, rtol {drtol:.4g}) on {int(valid.sum())} valid rows, "
                f"lengths {length.tolist()}; masked rows zero; two calls "
                f"bit-identical")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version "
                                     f"({label})")
        if lengths is not None and not graph_equals_eager(
                att.decode_attention_blocked, (q, k, v, length)):
            raise AssertionError(f"K4 replayed from a CUDA graph differs from "
                                 f"an eager call ({label})")
    fn = att.decode_attention_blocked
    for (label, H, Hkv, dk, S, dt) in SESSION_DECODE:
        dtype = getattr(torch, dt)
        # a split left out at length 2047 moves an output by ~1e-2
        dtol = 1e-3 if dtype == torch.bfloat16 else 1e-4
        errs = []
        for n in SESSION_LENGTHS:
            q, k, v, length = decode_inputs(1, H, Hkv, dk, S, dtype, dtype,
                                            seed=n + dk, lengths=[n])
            before = fn.launches
            out, out2 = fn(q, k, v, length), fn(q, k, v, length)
            ref = att.decode_attention_reference(q, k, v, length)
            torch.cuda.synchronize()
            if fn.launches - before != 2 or not torch.equal(out, out2):
                raise AssertionError(f"K4 {label} length {n}: launches rose by "
                                     f"{fn.launches - before}, or two calls differ")
            if not torch.isfinite(out.float()).all() or (n == 0 and (out != 0).any()):
                raise AssertionError(f"K4 {label} length {n}: non-finite output "
                                     f"or a nonzero length-0 row")
            err, ok = max_violation(out, ref, dtol) if n else (0.0, True)
            errs.append(err)
            dec_err["decode_attention_blocked"] = max(
                dec_err["decode_attention_blocked"], err)
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"({label}, length {n}): {err}")
        log(f"[parity] decode_attention_blocked {label} B=1 H={H} Hkv={Hkv} "
            f"dk={dk} S={S} {dt}, {att.decode_plan(1, H, Hkv, dk, S).splits} "
            f"splits: lengths {list(SESSION_LENGTHS)} (NaN past each), "
            f"max_abs_err {[f'{e:.3e}' for e in errs]} (tol {dtol}); length 0 "
            f"zero; two calls bit-identical")
    log(f"[parity] {time.perf_counter() - t0:.1f} s wall")
    return {"quant_matmul": k1_err, "quant_matmul4": max(k5_err.values()),
            "quant_matmul4_paths": k5_err, "prefill_quant": k2_err, **dec_err}


def parity_config():
    import dataclasses

    from freeze_omni_tpu_torch.config import flagship_system

    cfg = flagship_system()
    llm = dataclasses.replace(cfg.audio_llm.llm, num_layers=2, max_kv_len=1024)
    return dataclasses.replace(
        cfg, audio_llm=dataclasses.replace(cfg.audio_llm, llm=llm),
        serving=dataclasses.replace(cfg.serving, max_sessions=2, kv_quant_bits=8),
        sampling=dataclasses.replace(cfg.sampling, top_k=1),
        tts=dataclasses.replace(cfg.tts, top_k=1))


def phase_tick_parity(bits):
    """The tick, card against CPU, with int8 (`bits` = 8) or int4 (4) LLM
    weights drawn as the flagship server draws them."""
    import torch

    from freeze_omni_tpu_torch.models import audio_llm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parity_config()
    params = audio_llm.init_params(cfg.audio_llm, seed=1, device="cuda",
                                   quantize_llm=True, quant_bits=bits)
    return tick_parity(cfg, params, tree_to(params, "cpu"), 5,
                       f"int{bits} weights")


def tick_parity(cfg, gpu_params, cpu_params, n_ticks, label):
    """`n_ticks` dual ticks of two sessions through an engine on the card
    and one on the CPU, fed the same fbank windows: probabilities within
    5e-3, decisions and KV lengths equal. Returns (card engine, CPU engine,
    sids)."""
    import numpy as np

    from freeze_omni_tpu_torch.runtime.engine import ServingEngine

    gpu = ServingEngine(cfg, gpu_params, device="cuda")
    cpu = ServingEngine(cfg, cpu_params, device="cpu")
    sids = ["p0", "p1"]
    for sid in sids:
        gpu.open_session(sid)
        cpu.open_session(sid)
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
    log(f"[tick-parity] {label}, 2-layer flagship widths, {n_ticks} "
        f"dual ticks x 2 sessions: card vs cpu max |dprob| {worst:.3e} over "
        f"{compared} probabilities (atol {atol}); KV lengths equal")
    return gpu, cpu, sids


def _same_lengths(gpu, cpu, what):
    gl = gpu.store.caches.kv.length.cpu().tolist()
    cl = cpu.store.caches.kv.length.tolist()
    if gl != cl:
        raise AssertionError(f"{what}: KV lengths {gl} (card) vs {cl} (cpu)")


def _pcm_close(a, b, what):
    import numpy as np

    if a.shape != b.shape:
        raise AssertionError(f"{what}: PCM shapes {a.shape} vs {b.shape}")
    err = float(np.abs(a - b).max()) if a.size else 0.0
    if not (np.isfinite(a).all() and err <= PCM_TOL):
        raise AssertionError(f"{what}: card vs cpu PCM max |d| {err}")
    return err


def _pool_sentence(pool, key, hidden, prefix):
    """Start one sentence and step the pool until it finishes; returns its
    PCM, concatenated."""
    import numpy as np

    if pool.start([(key, hidden, prefix)]) != 1:
        raise AssertionError("the pool did not take the sentence")
    chunks = []
    while pool.n_active:
        for _, lst in pool.step().items():
            chunks += [pcm for pcm, _ in lst]
    return np.concatenate(chunks, axis=-1)


def phase_response_parity(gpu, cpu, sids):
    import dataclasses

    import numpy as np

    from freeze_omni_tpu_torch.runtime.tts_batch import BatchedTTS

    cfg = gpu.cfg
    tts_g = tts_params(cfg, seed=2)
    tts_c = tree_to(tts_g, "cpu")
    tcfg = dataclasses.replace(cfg.tts, max_tokens=PARITY_TTS_MAX_TOKENS)
    tape = SamplingTape()
    runs = {}
    for side, engine, tts, device in (("card", gpu, tts_g, "cuda"),
                                      ("cpu", cpu, tts_c, "cpu")):
        with tape.attached(replay=side == "cpu"):
            first = engine.respond_fast_many(sids, tts, n_text=8)
            last = {sid: first[sid][1][-1] for sid in sids}
            seg = engine.continue_segments(last, n_steps=8)
            if side == "card":
                toks, hids, _ = seg[sids[0]]
                sentence = sentence_inputs(
                    engine, fixed_sentences()[0],
                    [hids[j][None, None, :] for j in range(len(toks))])
            pool = BatchedTTS(tts, tcfg, capacity=2, seed=0, device=device)
            pcm = _pool_sentence(pool, "s", *sentence)
        runs[side] = (first, seg, pcm)
        if side == "card":
            log(f"[response-parity] card: {len(tape.tokens)} draws recorded")
    if tape.pos != len(tape.tokens):
        raise AssertionError(f"the CPU replayed {tape.pos} of "
                             f"{len(tape.tokens)} recorded draws")
    (f_g, s_g, p_g), (f_c, s_c, p_c) = runs["card"], runs["cpu"]
    pcm_err = 0.0
    for sid in sids:
        if f_g[sid][1] != f_c[sid][1] or s_g[sid][0] != s_c[sid][0]:
            raise AssertionError(f"{sid}: text tokens differ after replay")
        pcm_err = max(pcm_err, _pcm_close(f_g[sid][0], f_c[sid][0],
                                          f"first response {sid}"))
        hg, hc = s_g[sid][1], s_c[sid][1]
        rel = float((np.abs(hg - hc).max(1) / np.abs(hc).max(1)).max())
        if rel > HIDDEN_ROW_TOL:
            raise AssertionError(f"{sid}: continue hiddens differ by {rel:.3e} "
                                 f"of the row maximum")
    pcm_err = max(pcm_err, _pcm_close(p_g, p_c, "pooled sentence"))
    _same_lengths(gpu, cpu, "after the response")
    st = tape.stats
    log(f"[response-parity] 2-layer flagship LLM + flagship decoder/codec, "
        f"greedy, {len(sids)} sessions: respond_fast_many (n_text 8) + one "
        f"continue_segments round (8) + one BatchedTTS sentence "
        f"({p_g.shape[-1]} samples, max_tokens {PARITY_TTS_MAX_TOKENS}); "
        f"teacher-forced replay on the cpu: text {st['text']['flips']} near-tie "
        f"flips of {st['text']['draws']} draws (worst gap "
        f"{st['text']['worst_gap']:.3e}), codec {st['codec']['flips']} of "
        f"{st['codec']['draws']} (worst {st['codec']['worst_gap']:.3e}), margin "
        f"{TIE_FRAC}; PCM max |d| {pcm_err:.3e} (tol {PCM_TOL}); KV lengths equal")


def phase_tick_path():
    import dataclasses

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models import audio_llm
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
    log(f"[tick] flagship int8 params drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, params, kv_dtype=torch.bfloat16, device="cuda")
    sids = [f"s{i}" for i in range(cfg.serving.max_sessions)]
    max_ticks = 200
    feeds = session_feeds(cfg.duplex.gating, len(sids), max_ticks)

    zero_launches()
    t0 = time.perf_counter()
    for sid in sids:
        engine.open_session(sid)
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    at_open = read_launches()
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
    launches = read_launches()
    if rolls == 0:
        raise AssertionError(f"no KV roll fired in {tick} ticks")
    for name in ("quant_matmul", "prefill_quant"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the tick path")
    # first 5 ticks excluded (warm-up)
    front, eng = np.array(front_ms[5:]), np.array(engine_ms[5:])
    whole = front + eng
    peak = torch.cuda.max_memory_allocated()
    log(f"[tick] 8 sessions opened (role prefill + pool seed) in {open_s:.2f} s")
    log(f"[tick] {tick} dual ticks, {probs_seen} user predictions, {rolls} "
        f"session KV rolls; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    log(f"[tick] tick with host frontend (16 chunks gated) {pct(whole)} against "
        f"the {BUDGET_MS:.0f} ms budget; host frontend alone {pct(front)}; "
        f"engine.tick alone {pct(eng)}")
    per_tick = {k: (launches[k] - at_open[k]) / tick for k in launches}
    return engine, sids, launches, per_tick


def phase_response_path(engine, sids, smi):
    """The spoken response of all 8 sessions, as runtime/service.py drives
    it: respond_fast_many, continue_segments rounds, sentences into the
    BatchedTTS pool, stepped until every sentence has finished."""
    import dataclasses

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.duplex.responder import split_sentences
    from freeze_omni_tpu_torch.runtime.tts_batch import BatchedTTS

    cfg = engine.cfg
    tok = engine.core.tokenizer
    eod = tok.eod_id
    sr = cfg.tts.codec.sample_rate
    tts = tts_params(cfg, seed=3)
    pool = BatchedTTS(tts, dataclasses.replace(cfg.tts, max_tokens=TTS_MAX_TOKENS),
                      capacity=8, seed=0, device="cuda")
    texts = fixed_sentences()
    audio = {sid: [] for sid in sids}
    sentences = {sid: 0 for sid in sids}
    queues = {sid: [] for sid in sids}
    in_flight = set()

    def take(sid, pcm):
        if not (np.isfinite(pcm).all() and np.abs(pcm).max(initial=0.0) <= 1.0):
            raise AssertionError(f"{sid}: PCM not finite or outside [-1, 1]")
        audio[sid].append(pcm)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    first = engine.respond_fast_many(sids, tts, n_text=8)
    first_ms = (time.perf_counter() - t0) * 1e3
    resp = {}
    for sid, (pcm, toks) in first.items():
        if pcm.shape[-1] == 0:
            raise AssertionError(f"{sid}: no first-response audio")
        take(sid, pcm)
        if toks and toks[-1] != eod and len(toks) < cfg.duplex.resp_max_tokens:
            resp[sid] = {"last": toks[-1], "n": len(toks), "toks": [], "hids": []}
    round_ms, step_ms, step_audio_s, step_decoded_s = [], [], [], []
    token_s = cfg.tts.codec.upsample_rate / sr           # audio per codec token
    while resp or any(queues.values()) or pool.n_active:
        if resp:
            t0 = time.perf_counter()
            out = engine.continue_segments({s: r["last"] for s, r in resp.items()},
                                           n_steps=cfg.duplex.resp_segment)
            round_ms.append((time.perf_counter() - t0) * 1e3)
            for sid, (toks, hids, done) in out.items():
                r = resp[sid]
                per_tok = [hids[j][None, None, :] for j in range(len(toks))]
                r["n"] += len(toks)
                queues[sid] += split_sentences(tok, eod, r["toks"], r["hids"],
                                               toks, per_tok)
                # random-weight ids carry no sentence suffix: every segment
                # ends a sentence, so a sentence holds at most one segment
                if r["toks"]:
                    queues[sid].append((list(r["toks"]), list(r["hids"])))
                    r["toks"].clear()
                    r["hids"].clear()
                r["last"] = toks[-1] if toks else eod
                if done or r["n"] >= cfg.duplex.resp_max_tokens:
                    del resp[sid]
        jobs = []
        for sid in sids:   # at most one sentence in flight per session
            if sid not in in_flight and queues[sid] and len(jobs) < pool.n_free:
                _, hids = queues[sid].pop(0)
                text = texts[sentences[sid] % len(texts)]
                jobs.append(((sid, sentences[sid]),
                             *sentence_inputs(engine, text, hids)))
                sentences[sid] += 1
                in_flight.add(sid)
        if jobs and pool.start(jobs) != len(jobs):
            raise AssertionError("the pool refused sentences it had room for")
        if pool.n_active:
            step_decoded_s.append(pool.n_active * cfg.tts.codec_chunk_size * token_s)
            t0 = time.perf_counter()
            emitted = pool.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n = 0
            for (sid, _), lst in emitted.items():
                for pcm, final in lst:
                    take(sid, pcm)
                    n += pcm.shape[-1]
                    if final:
                        in_flight.discard(sid)
            step_audio_s.append(n / sr)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for name in ("quant_matmul", "prefill_quant", "decode_attention_blocked"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"response path")
    seconds = {sid: sum(p.shape[-1] for p in audio[sid]) / sr for sid in sids}
    for sid in sids:
        if sentences[sid] == 0 or len(audio[sid]) < 2:
            raise AssertionError(f"{sid}: no pooled sentence was synthesized")
    log(f"[response] ({smi}) 8 sessions: respond_fast_many (B=8, n_text 8, "
        f"{cfg.tts.codec_chunk_size + cfg.tts.codec_padding_size} codec "
        f"tokens, dialog_ss to first PCM on the host) {first_ms:.2f} ms")
    log(f"[response] continue_segments rounds of {cfg.duplex.resp_segment} "
        f"tokens (up to {cfg.duplex.resp_max_tokens}): {len(round_ms)} rounds, "
        f"ms per round {[round(x, 2) for x in round_ms]}")
    log(f"[response] BatchedTTS (capacity 8, max_tokens cut to {TTS_MAX_TOKENS}; "
        f"each sentence's text is a fixed sentence of "
        f"freeze_omni_tpu/assets/tiny_s2s/sentences.txt, its prefix the real "
        f"hiddens): {sum(sentences.values())} sentences, {len(step_ms)} steps, "
        f"step {pct(step_ms)}; audio decoded per step (active rows x "
        f"{cfg.tts.codec_chunk_size} tokens) p50 "
        f"{np.percentile(step_decoded_s, 50):.3f} s, p90 "
        f"{np.percentile(step_decoded_s, 90):.3f} s; audio emitted per step "
        f"(after seam splicing) p50 {np.percentile(step_audio_s, 50):.3f} s, "
        f"p90 {np.percentile(step_audio_s, 90):.3f} s")
    log(f"[response] seconds of audio per session "
        f"{[round(seconds[s], 3) for s in sids]}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    return {"launches": launches, "pool": pool, "n_responses": len(sids),
            "first_ms": first_ms, "round_ms": round_ms, "step_ms": step_ms}


SERVE_ARGV = ["--preset", "flagship", "--engine", "--quant", "4", "--kv_quant", "8",
              "--max_sessions", "8", "--respond", "--seed", "0"]
LINE_NOISE = 5e-4   # the system line's background, -66 dBFS


def speech_surrogate(rng, n, sr=16000):
    """Voiced-speech surrogate (a copy of synth_speech in the JAX package's
    training/vad.py, on which the learned VAD's weights were trained): a
    harmonic stack with a pitch contour, 1-2 formant resonances and 3-7 Hz
    syllabic amplitude modulation, peak-normalised."""
    import numpy as np

    t = np.arange(n) / sr
    f0 = rng.uniform(80, 260)
    vibrato = f0 * 0.03 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
    drift = f0 * 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t)
    phase = 2 * np.pi * np.cumsum(f0 + vibrato + drift) / sr
    formants = rng.uniform(300, 3000, size=rng.randint(1, 3))
    bw = rng.uniform(80, 300, size=formants.shape)
    sig = np.zeros(n)
    for k in range(1, 13):
        fk = k * f0
        amp = sum(np.exp(-((fk - fc) ** 2) / (2 * b ** 2))
                  for fc, b in zip(formants, bw)) + 0.05 / k
        sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 7) * t
                                      + rng.uniform(0, 2 * np.pi)))
    return (sig / (np.abs(sig).max() + 1e-8)).astype(np.float32)


def user_streams(n_sessions, n):
    """Per session: a quiet lead-in (1-3 chunks), 1.5 s of speech, 1.5 s of
    silence, 6 s of speech, then silence. The speech is the surrogate above
    at half scale: the learned VAD (the user default) does not fire on the
    committed dev wavs (synthetic tiny-TTS speech; its probability stays
    below 0.11 on 99% of their 224 ms chunks)."""
    import numpy as np

    out = []
    for s in range(n_sessions):
        rng = np.random.RandomState(100 + s)
        out.append(np.concatenate([
            np.zeros((1 + s % 3) * n, np.float32),
            0.5 * speech_surrogate(rng, 24000), np.zeros(24000, np.float32),
            0.5 * speech_surrogate(rng, 96000)]))
    return out


def phase_service(smi, int8_llm_bytes):
    """The int4 serving path at full width and depth, through the port's
    Server (bin/serve.py --engine --quant 4) and its DuplexService, stepped
    here one step at a time (the ticker thread is stopped) so each step is
    timed. 8 sessions stream speech as users (user_streams), 224 ms per
    identity per step, and a quiet line as the system; once every user's first IPU has
    closed, one step at threshold 0 makes the sessions inside their next IPU
    speak (respond_fast_many), the users fall silent, and the service runs
    the continuation rounds and the pooled sentences until flush_tts finds
    the pool empty."""

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.bin.serve import Server, get_args

    torch.backends.cudnn.allow_tf32 = True   # serving default
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = Server(get_args(SERVE_ARGV))
    server.stop_ticker()
    if server._ticker_thread.is_alive():
        raise AssertionError("the server's ticker thread did not stop")
    svc, engine = server.service, server.service.engine
    cfg = svc.cfg
    svc.resp_threshold = 2.0   # nobody speaks until the threshold-0 step
    torch.cuda.synchronize()
    log(f"[serve] Server({' '.join(SERVE_ARGV)}) built in "
        f"{time.perf_counter() - t0:.1f} s; ticker stopped")
    llm = engine.core.params["llm"]
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        if "w_q4" not in llm["layers"][name]:
            raise AssertionError(f"layer projection {name} is not int4")
    int4_llm_bytes = llm_bytes(llm)

    # random-weight text ids are almost all >= 256, which the byte tokenizer
    # drops: each pooled sentence takes a fixed sentence as its text (its
    # prefix stays its own hiddens), as phase 7 does
    texts, count = fixed_sentences(), itertools.count()
    prepare = svc._prepare_sentence
    svc._prepare_sentence = lambda text, hids: prepare(
        texts[next(count) % len(texts)], hids)

    clock = {"front": 0.0, "vad": 0.0, "tick": 0.0, "cont": 0.0}
    activity = {"respond": 0, "continue": 0, "pool": 0}

    def timed(fn, key, sync=False):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t
            return out
        return run

    def counted(fn, key, when=lambda: True):
        def run(*a, **k):
            if when():
                activity[key] += 1
            return fn(*a, **k)
        return run

    svc._vad_stage = timed(svc._vad_stage, "front")
    engine.tick = timed(engine.tick, "tick", sync=True)
    # a continuation round: resp_segment text-decode steps of every
    # speaking session, with the sentence routing after them
    svc._continue_responses = timed(svc._continue_responses, "cont", sync=True)
    engine.respond_fast_many = counted(engine.respond_fast_many, "respond")
    engine.continue_segments_submit = counted(engine.continue_segments_submit,
                                              "continue")
    pool = svc._tts
    pool.step_submit = counted(pool.step_submit, "pool", when=lambda: bool(pool.jobs))

    sids = [f"u{i}" for i in range(cfg.serving.max_sessions)]
    sinks = {sid: svc.open_session(sid) for sid in sids}
    for fe in svc.sessions.values():
        # the host frontend runs the native core (phase 13 holds and times it)
        if fe.vad["user"]._native is None or any(
                g._native is None for g in fe.gating.values()):
            raise AssertionError("the service frontend did not take the native core")
        for v in fe.vad.values():
            v.predict = timed(v.predict, "vad")
    n = cfg.duplex.gating.samples_per_chunk
    users = user_streams(len(sids), n)
    rng = np.random.RandomState(0)
    torch.cuda.synchronize()

    def events(sid, name, identity=None):
        return [e for e in sinks[sid].events_of(name)
                if identity is None or e.get("identity") == identity]

    zero_launches()
    steps = []   # per step: kind, ms, front, vad, tick, launches
    trigger, responders, pos = None, [], 0
    deepest = []   # the pool rows' lengths after its deepest step
    while len(steps) < 400:
        k = len(steps)
        talking = trigger is None
        for i, sid in enumerate(sids):
            chunk = users[i][pos:pos + n] if talking else np.zeros(0, np.float32)
            chunk = np.concatenate([chunk, np.zeros(n - len(chunk), np.float32)])
            svc.enqueue_audio_data(sid, "user", {"audio": chunk})
            svc.enqueue_audio_data(sid, "system", {
                "audio": (LINE_NOISE * rng.randn(n)).astype(np.float32)})
        pos += n
        closed = all(any(e["status"] == "ipu_el" for e in events(sid, "vad_event", "user"))
                     for sid in sids)
        in_ipu = sum(svc.sessions[sid].vad["user"].in_speech for sid in sids)
        fire = talking and closed and (in_ipu >= len(sids) // 2 or
                                       (in_ipu and k >= 120))
        if fire:
            svc.resp_threshold = 0.0
        for key in clock:
            clock[key] = 0.0
        for key in activity:
            activity[key] = 0
        before = read_launches()
        t0 = time.perf_counter()
        svc.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        lengths = pool.state.cache.kv.length.tolist()
        if sum(lengths) > sum(deepest):
            deepest = lengths
        if fire:
            svc.resp_threshold = 2.0
            trigger = k
            responders = [sid for sid in sids if events(sid, "response_audio")]
            if not responders:
                raise AssertionError("the threshold-0 step made no session speak")
        kind = "tick" if not any(activity.values()) else "response"
        steps.append({"kind": kind, "ms": ms, "front": clock["front"] * 1e3,
                      "vad": clock["vad"] * 1e3, "tick": clock["tick"] * 1e3,
                      "cont": clock["cont"] * 1e3,
                      "launches": {key: after[key] - before[key] for key in after},
                      **dict(activity)})
        if trigger is not None and k > trigger:
            idle = all(fe.resp is None and fe.tts_key is None and not fe.tts_queue
                       for fe in svc.sessions.values())
            if idle and pool.n_active == 0:
                break
    else:
        raise AssertionError(f"the response did not finish in {len(steps)} steps")
    svc.flush_tts()
    if pool.n_active or any(fe.tts_queue or fe.tts_key is not None
                            for fe in svc.sessions.values()):
        raise AssertionError("flush_tts left sentences in the pool")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    # checks: events, audio, kernels
    for sid in sids:
        st = [e["status"] for e in events(sid, "vad_event", "user")]
        if "ipu_sl" not in st or "ipu_el" not in st:
            raise AssertionError(f"{sid}: user VAD events {st}")
        upd = events(sid, "dialog_state_update")
        if not upd or not all(np.isfinite([u["probs"]["state_1"], u["probs"]["state_2"]]).all()
                              for u in upd):
            raise AssertionError(f"{sid}: no finite dialog_state_update")
        if events(sid, "error"):
            raise AssertionError(f"{sid}: error events {events(sid, 'error')}")
    audio = {sid: events(sid, "response_audio") for sid in responders}
    for sid, chunks in audio.items():
        for a in chunks:
            pcm = a["pcm"]
            if not (np.isfinite(pcm).all() and np.abs(pcm).max(initial=0.0) <= 1.0):
                raise AssertionError(f"{sid}: response PCM not finite or outside [-1, 1]")
    pooled = {sid: [a for a in audio[sid] if a["sr"] == 16000] for sid in responders}
    if not any(pooled.values()):
        raise AssertionError("no pooled sentence audio")
    heard = [sid for sid in responders if events(sid, "vad_event", "system")]
    if not heard:
        raise AssertionError("no system-identity VAD event: the response audio "
                             "did not re-enter as system audio")
    ticks = [st for st in steps if st["kind"] == "tick"]
    resp = [st for st in steps if st["kind"] == "response"]
    for st in ticks:
        if st["launches"]["quant_matmul"]:
            raise AssertionError(f"K1 launched on a tick-only step: {st}")
    for key in ("quant_matmul4", "prefill_quant"):
        if not sum(st["launches"][key] for st in ticks):
            raise AssertionError(f"{key} was not launched on the tick steps")
    for key in ("quant_matmul", "decode_attention_blocked", "quant_matmul4_small"):
        if not sum(st["launches"][key] for st in resp):
            raise AssertionError(f"{key} was not launched in the response")

    def col(rows, key, skip=0):
        return np.array([r[key] for r in rows[skip:]])

    seconds = {sid: round(sum(a["pcm"].shape[-1] / a["sr"] for a in audio[sid]), 3)
               for sid in responders}
    per_tick = {key: sum(st["launches"][key] for st in ticks) / len(ticks)
                for key in launches}
    per_resp = {key: sum(st["launches"][key] for st in resp) / len(responders)
                for key in launches}
    log(f"[serve] ({smi}) {len(steps)} steps: {len(ticks)} tick-only, {len(resp)} "
        f"with response work; threshold-0 step {trigger}; {len(responders)} "
        f"sessions spoke ({', '.join(responders)}); system VAD heard the "
        f"feedback in {len(heard)}")
    log(f"[serve] tick-only step ({len(sids)} sessions, both identities; first "
        f"5 excluded) {pct(col(ticks, 'ms', 5))} against {BUDGET_MS:.0f} ms; "
        f"host frontend (VAD + gating + serializer) {pct(col(ticks, 'front', 5))}; "
        f"VAD alone ({2 * len(sids)} streams) {pct(col(ticks, 'vad', 5))}; "
        f"engine.tick {pct(col(ticks, 'tick', 5))}")
    log(f"[serve] response steps {pct(col(resp, 'ms'))}; respond_fast_many "
        f"steps {sum(st['respond'] for st in resp)}, continuation rounds "
        f"{sum(st['continue'] for st in resp)}, pool steps "
        f"{sum(st['pool'] for st in resp)}; audio per speaking session (s) {seconds}")
    rounds = [st for st in resp if st["continue"]]
    if rounds:
        seg = cfg.duplex.resp_segment
        log(f"[serve] ({smi}) continuation rounds ({len(rounds)}, "
            f"{seg} text steps each): ms per round "
            f"{[round(st['cont'], 2) for st in rounds]}; per text step "
            f"{[round(st['cont'] / seg, 2) for st in rounds]}; K5 small-N "
            f"launches per round {[st['launches']['quant_matmul4_small'] for st in rounds]}")
    log(f"[serve] resident LLM weights: int4 {int4_llm_bytes / 2**30:.3f} GiB "
        f"({int4_llm_bytes} B) vs int8 {int8_llm_bytes / 2**30:.3f} GiB "
        f"({int8_llm_bytes} B); peak device memory {peak / 2**30:.2f} GiB")
    log(f"[serve] launches {launches}; per tick-only step {per_tick}; per "
        f"speaking session {per_resp}")
    log(f"[serve] the pool's rows ({pool.state.cache.kv.k.shape[2]} slots) after "
        f"its deepest step: {deepest}")
    return {"server": server, "launches": launches, "per_tick": per_tick,
            "per_response": per_resp, "pool": pool, "pool_lengths": deepest,
            "front_ms": col(ticks, "front", 5)}


def dense_bf16_ms(x, w):
    """A dense bf16 torch.matmul on the weights w [K, O] dequantized to bf16
    before the timed window: a reference ceiling for a kernel that reads the
    same x, not a call of the same function (it reads 2 bytes a weight),
    and never on the port's path."""
    from freeze_omni_tpu_torch.bin.timing import cuda_time_ms

    return cuda_time_ms(lambda: torch_matmul(x, w))


def torch_matmul(x, w):
    import torch

    return torch.matmul(x, w)


def k1_time(x, w_q, scale, lib_iters=50):
    """K1's kernel (eager and device time), plain, library (`lib_iters`
    timed calls) and dense bf16 times and its bound on x @ w."""
    import torch

    from freeze_omni_tpu_torch.bin.timing import bound, cuda_time_ms, graph_time_ms
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    N, K = x.shape
    O = w_q.shape[1]
    w_t = w_q.t().contiguous()            # the library call wants [O, K]
    s_b = scale.to(torch.bfloat16)        # and scales in x's dtype
    r = {"ms": cuda_time_ms(lambda: qm.quant_matmul(x, w_q, scale)),
         "device_ms": graph_time_ms(lambda: qm.quant_matmul(x, w_q, scale)),
         "plain_ms": cuda_time_ms(lambda: qm.quant_matmul_reference(x, w_q, scale),
                                  iters=10),
         "library_ms": cuda_time_ms(lambda: torch._weight_int8pack_mm(x, w_t, s_b),
                                    iters=lib_iters, warmup=min(5, lib_iters)),
         "bytes": K * O + 4 * O + 2 * N * K + 2 * N * O, "ops": 2 * N * K * O,
         "splits": qm.tile_plan(N, K, O)[2]}
    del w_t
    w_d = (w_q.float() * scale[None, :]).to(torch.bfloat16)
    r["dense_bf16_ms"] = dense_bf16_ms(x, w_d)
    del w_d
    return r


def k1_layer(layers, lm_head, N, g, lib_iters=50):
    """One layer's seven projections (and the lm_head when given) at N rows."""
    import torch

    from freeze_omni_tpu_torch.bin.timing import bound

    total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "dense_bf16_ms": 0.0, "bytes": 0, "ops": 0}
    mats = [(name, layers[name]["w_q"][0], layers[name]["scale"][0])
            for name in ("q", "k", "v", "o", "gate", "up", "down")]
    if lm_head is not None:
        mats.append(("lm_head", lm_head["w_q"], lm_head["scale"]))
    for name, w_q, scale in mats:
        K, O = w_q.shape
        x = torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
        r = k1_time(x, w_q, scale, lib_iters)
        b_ms, b_by = bound(r["bytes"], r["ops"])
        log(f"[time] K1 {name} N={N} K={K} O={O} splits={r['splits']}: kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), bound {b_ms:.4f} ms "
            f"({b_by}), plain {r['plain_ms']:.4f} ms, torch._weight_int8pack_mm "
            f"{r['library_ms']:.4f} ms, dense bf16 matmul {r['dense_bf16_ms']:.4f} ms")
        for key in total:
            total[key] += r[key]
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["ops"])
    return total


def k5_time(x, w_q4, scale4, group):
    """K5's kernel, plain and library times and its bound on one projection.
    The library call is torch._weight_int4pack_mm on the same weights
    repacked for it (transposed to [O, K/2], even input row in the high
    nibble, zero points 0); it is timed and its result held to the plain
    version, and if this torch build refuses it, its error is returned."""
    import torch

    from freeze_omni_tpu_torch.bin.timing import bound, cuda_time_ms, graph_time_ms
    from freeze_omni_tpu_torch.ops import quant_matmul as qm
    from freeze_omni_tpu_torch.ops.quant import dequantize_weight_int4

    N, K = x.shape
    O = w_q4.shape[1]
    r = {"ms": cuda_time_ms(lambda: qm.quant_matmul4(x, w_q4, scale4, group)),
         "device_ms": graph_time_ms(lambda: qm.quant_matmul4(x, w_q4, scale4, group)),
         "plain_ms": cuda_time_ms(
             lambda: qm.quant_matmul4_reference(x, w_q4, scale4, group), iters=10),
         "library_ms": None, "library_device_ms": None, "library_error": None,
         "bytes": K * O // 2 + 4 * scale4.numel() + 2 * N * K + 2 * N * O,
         "ops": 2 * N * K * O}
    w_d = dequantize_weight_int4({"w_q4": w_q4, "scale4": scale4},
                                 dtype=torch.float32).to(torch.bfloat16)
    r["dense_bf16_ms"] = dense_bf16_ms(x, w_d)
    del w_d
    try:
        w_t = w_q4.t().contiguous()
        packed = torch._convert_weight_to_int4pack(((w_t & 0xF) << 4) | (w_t >> 4), 8)
        sz = torch.stack([scale4, torch.zeros_like(scale4)], -1).to(torch.bfloat16)
        lib = torch._weight_int4pack_mm(x, packed, group, sz)
        err = float((lib.float() - qm.quant_matmul4_reference(
            x, w_q4, scale4, group).float()).abs().max())
        r["library_ms"] = cuda_time_ms(
            lambda: torch._weight_int4pack_mm(x, packed, group, sz))
        r["library_device_ms"] = graph_time_ms(
            lambda: torch._weight_int4pack_mm(x, packed, group, sz))
        r["library_max_abs_err"] = err
        del w_t, packed, sz, lib
    except RuntimeError as e:   # the yardstick only: never on the port's path
        r["library_error"] = str(e).splitlines()[0][:200]
    return r


def k5_layer(layers, N, g):
    """One layer's seven int4 projections at N rows."""
    import torch

    from freeze_omni_tpu_torch.bin.timing import bound

    total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "library_device_ms": 0.0, "dense_bf16_ms": 0.0, "bytes": 0, "ops": 0}
    errors = []
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        w_q4, scale4 = layers[name]["w_q4"][0], layers[name]["scale4"][0]
        Kp, O = w_q4.shape
        group = 2 * Kp // scale4.shape[0]
        x = torch.randn((N, 2 * Kp), generator=g, device="cuda").to(torch.bfloat16)
        r = k5_time(x, w_q4, scale4, group)
        b_ms, b_by = bound(r["bytes"], r["ops"])
        lib = (f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}; "
               f"max |d| vs plain {r['library_max_abs_err']:.3e})"
               if r["library_error"] is None
               else f"refused: {r['library_error']}")
        log(f"[time] K5 {name} N={N} K={2 * Kp} O={O} group={group}: kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), bound {b_ms:.4f} ms "
            f"({b_by}), plain {r['plain_ms']:.4f} ms, torch._weight_int4pack_mm {lib}, "
            f"dense bf16 matmul {r['dense_bf16_ms']:.4f} ms")
        for key in ("ms", "device_ms", "plain_ms", "dense_bf16_ms", "bytes", "ops"):
            total[key] += r[key]
        if r["library_error"] is None:
            total["library_ms"] += r["library_ms"]
            total["library_device_ms"] += r["library_device_ms"]
        else:
            errors.append(r["library_error"])
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["ops"])
    if errors:
        total["library_ms"], total["library_error"] = None, errors[0]
        total["library_device_ms"] = None
    return total


def llm_bytes(llm):
    """Resident bytes of an LLM parameter tree."""
    if isinstance(llm, dict):
        return sum(llm_bytes(v) for v in llm.values())
    return llm.numel() * llm.element_size()


def k2_time(kv, qend, H, g):
    """K2 on the live layer-0 cache with `qend`: eager and device time
    (graph_time_ms), the bound (bin/k2_profile.k2_bound), the plain
    version, and sdpa_bf16_ms: scaled_dot_product_attention on the cache
    dequantized to bf16 before the timed window, with the qend mask
    (bin/k2_profile.sdpa_bf16: a reference ceiling, not the same function,
    never on the port's path)."""
    import torch

    from freeze_omni_tpu_torch.bin.k2_profile import k2_bound, sdpa_bf16
    from freeze_omni_tpu_torch.bin.timing import cuda_time_ms, graph_time_ms
    from freeze_omni_tpu_torch.ops import attention as att

    B, T = qend.shape
    S, Hkv, dk = kv.k.shape[-3:]
    q = torch.randn((B, T, H, dk), generator=g, device="cuda").to(torch.bfloat16)
    args = (q, kv.k[0], kv.k_scale[0], kv.v[0], kv.v_scale[0], qend)
    b_ms, b_by = k2_bound(qend, H, Hkv, dk)
    return {"ms": cuda_time_ms(lambda: att.prefill_quant(*args)),
            "device_ms": graph_time_ms(lambda: att.prefill_quant(*args)),
            "plain_ms": cuda_time_ms(lambda: att.prefill_quant_reference(*args),
                                     iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "sdpa_bf16_ms": graph_time_ms(sdpa_bf16(*args)),
            "splits": att.prefill_plan(B, T, H, Hkv, dk, S).splits,
            "visible": qend.long().amax(dim=1).tolist()}


def decode_time(fn, k, v, length, H, g):
    """A decode-attention kernel on cache k/v [B, S, Hkv, dk] with `length`:
    eager, device and cold-L2 device time (bin/k4_profile.time_decode), the
    bound (k4_profile.decode_bound), the plain version, and one
    scaled_dot_product_attention call with the length mask
    (k4_profile.sdpa_masked: the same function, timed only)."""
    import torch

    from freeze_omni_tpu_torch.bin.k4_profile import (decode_bound, sdpa_masked,
                                                      time_decode)
    from freeze_omni_tpu_torch.bin.timing import cuda_time_ms, graph_time_ms
    from freeze_omni_tpu_torch.ops import attention as att

    B, S, Hkv, dk = k.shape
    q = torch.randn((B, H, dk), generator=g, device="cuda").to(k.dtype)
    t = time_decode(fn, q, k, v, length)
    b_ms, b_by = decode_bound(q, k, length)
    sdpa = sdpa_masked(q, k, v, length)
    return {"ms": t["eager_ms"], "device_ms": t["device_ms"], "cold_ms": t["cold_ms"],
            "plain_ms": cuda_time_ms(
                lambda: att.decode_attention_reference(q, k, v, length), iters=10),
            "library_ms": cuda_time_ms(sdpa), "library_device_ms": graph_time_ms(sdpa),
            "bound_ms": b_ms, "bound_by": b_by}


def log_decode_time(name, label, r, smi):
    log(f"[time] {name} {label} shape ({smi}): kernel {r['ms']:.4f} ms eager, "
        f"{r['device_ms']:.4f} ms device, {r['cold_ms']:.4f} ms device with the "
        f"cache cold in L2, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), plain "
        f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
        f"{r['library_ms']:.4f} ms eager, {r['library_device_ms']:.4f} ms device")


def phase_kernel_times(engine, tick, resp, errs, smi):
    import torch

    from freeze_omni_tpu_torch.ops import attention as att

    engine_launches, per_tick = tick
    cfg = engine.cfg.audio_llm.llm
    params = engine.core.params["llm"]
    g = torch.Generator(device="cuda").manual_seed(7)
    N = engine.store.max_sessions * 29   # 8+4+13+4 tokens per session per dual tick
    k1 = k1_layer(params["layers"], None, N, g)
    k1_dec = k1_layer(params["layers"], params["lm_head"], engine.store.max_sessions, g)
    for label, t in ((f"7 projections at N={N}", k1),
                     (f"7 projections + lm_head at N={engine.store.max_sessions}",
                      k1_dec)):
        log(f"[time] K1 one layer's {label} ({smi}): kernel {t['ms']:.4f} ms eager, "
            f"{t['device_ms']:.4f} ms device, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
            f"torch._weight_int8pack_mm {t['library_ms']:.4f} ms, dense bf16 "
            f"matmul {t['dense_bf16_ms']:.4f} ms")

    # K2 on the live layer-0 cache: a regular tick's qend (prefixes masked,
    # both identities' 4 chunk tokens valid), and a text-decode step (T = 1)
    kv = engine.store.caches.kv
    B, S = kv.k.shape[1], kv.k.shape[2]
    mask = torch.zeros((B, 29), dtype=torch.bool, device="cuda")
    mask[:, 8:12] = True
    mask[:, 25:29] = True
    rank = torch.cumsum(mask.long(), 1) - 1
    qend = torch.where(mask, kv.length.long()[:, None] + rank + 1,
                       torch.zeros_like(rank)).to(torch.int32)
    k2 = k2_time(kv, qend, cfg.num_heads, g)
    k2_dec = k2_time(kv, (kv.length.long() + 1)[:, None].to(torch.int32),
                     cfg.num_heads, g)
    for label, r in (("T=29", k2), ("T=1", k2_dec)):
        log(f"[time] K2 B={B} {label} S={S} ({smi}) visible slots/row "
            f"{r['visible']}, {r['splits']} splits: kernel {r['ms']:.4f} ms "
            f"eager, {r['device_ms']:.4f} ms device, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention on bf16 K/V {r['sdpa_bf16_ms']:.4f} ms "
            f"device (not the same function, never on the path)")

    # K3/K4 on the speech decoder: the BatchedTTS pool's live layer-0 cache
    # (f32, S = 8*32 + 1 + max_tokens + 8) with the lengths its rows ended
    # at, and first_response's cache (S = 2048) with 73..123 visible slots
    dcfg = engine.cfg.tts.decoder
    pkv = resp["pool"].state.cache.kv
    pool_len = pkv.length.clone()
    fr_S = dcfg.max_kv_len
    fr_len = torch.linspace(73, 123, 8, device="cuda").round().to(torch.int32)
    fr_k = torch.randn((8, fr_S, dcfg.num_heads, dcfg.head_dim), generator=g,
                       device="cuda")
    fr_v = torch.randn(fr_k.shape, generator=g, device="cuda")
    dec = {}
    for name in ("decode_attention", "decode_attention_blocked"):
        fn = getattr(att, name)
        dec[name] = decode_time(fn, pkv.k[0], pkv.v[0], pool_len, dcfg.num_heads, g)
        dec[name]["first_response"] = decode_time(fn, fr_k, fr_v, fr_len,
                                                  dcfg.num_heads, g)
        for label, r in (("pool", dec[name]), ("first_response",
                                               dec[name]["first_response"])):
            log_decode_time(name, label, r, smi)
    log(f"[time] K3/K4 pool shape B={pkv.k.shape[1]} S={pkv.k.shape[2]} "
        f"H={dcfg.num_heads} dk={dcfg.head_dim} lengths {pool_len.tolist()}; "
        f"first_response shape S={fr_S} lengths {fr_len.tolist()}; K4 splits "
        f"{att.decode_plan(pkv.k.shape[1], dcfg.num_heads, pkv.k.shape[3], dcfg.head_dim, pkv.k.shape[2]).splits}")

    launches = {k: engine_launches[k] + resp["launches"][k] for k in engine_launches}
    n_resp = resp["n_responses"]

    def entry(name, source, replaces, key, timing, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": timing["ms"],
                "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
                "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
                "launches_tick_path": engine_launches[key],
                "launches_response_path": resp["launches"][key],
                "launches_per_tick": per_tick[key],
                "launches_per_response": resp["launches"][key] / n_resp,
                "card": smi, **extra}

    def short(t):
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "device_ms", "cold_ms",
                                  "library_device_ms") if k in t}

    def short_extra(t):
        return {"device_ms": t["device_ms"], "cold_ms": t["cold_ms"],
                "library_device_ms": t["library_device_ms"],
                "first_response_shape": short(t["first_response"])}

    return [
        entry("quant_matmul (K1, one layer's 7 projections at N=232)",
              "freeze_omni_tpu_torch/csrc/quant_matmul.cu",
              "freeze_omni_tpu/ops/quant_matmul.py:41", "quant_matmul", k1,
              device_ms=k1["device_ms"], dense_bf16_ms=k1["dense_bf16_ms"],
              decode_step_N8_with_lm_head={
                  **short(k1_dec), "device_ms": k1_dec["device_ms"],
                  "dense_bf16_ms": k1_dec["dense_bf16_ms"]}),
        entry("prefill_quant (K2, one layer at B=8 T=29 S=1024)",
              "freeze_omni_tpu_torch/csrc/prefill_quant.cu",
              "freeze_omni_tpu/ops/attention.py:190", "prefill_quant", k2,
              device_ms=k2["device_ms"], sdpa_bf16_ms=k2["sdpa_bf16_ms"],
              decode_step_T1={**short(k2_dec), "device_ms": k2_dec["device_ms"],
                              "sdpa_bf16_ms": k2_dec["sdpa_bf16_ms"]}),
        entry("decode_attention (K3, off the main path; timed at the "
              "BatchedTTS pool shape)",
              "freeze_omni_tpu_torch/csrc/decode_attention.cu",
              "freeze_omni_tpu/ops/attention.py:82", "decode_attention",
              dec["decode_attention"], on_main_path=False,
              **short_extra(dec["decode_attention"])),
        entry("decode_attention_blocked (K4, one decoder layer at the "
              "BatchedTTS pool shape)",
              "freeze_omni_tpu_torch/csrc/decode_attention.cu",
              "freeze_omni_tpu/ops/attention.py:369", "decode_attention_blocked",
              dec["decode_attention_blocked"],
              **short_extra(dec["decode_attention_blocked"])),
    ]


def k5_crossover(layers, g):
    """Both K5 paths forced on the server's layer-0 q and gate weights at
    N in CROSSOVER_NS: per N, each path's time (ms) on each shape and the
    sum. The largest N in 8..16 at which the small path still wins on the
    sum is the SMALL_N this table supports."""
    import torch

    from freeze_omni_tpu_torch.bin.timing import cuda_time_ms
    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    rows = []
    for N in CROSSOVER_NS:
        row = {"N": N, "small": {}, "tile": {}}
        for name in ("q", "gate"):
            w_q4, scale4 = layers[name]["w_q4"][0], layers[name]["scale4"][0]
            group = 2 * w_q4.shape[0] // scale4.shape[0]
            x = torch.randn((N, 2 * w_q4.shape[0]), generator=g,
                            device="cuda").to(torch.bfloat16)
            for path in ("small", "tile"):
                row[path][name] = cuda_time_ms(
                    lambda: qm.quant_matmul4(x, w_q4, scale4, group, path=path))
        for path in ("small", "tile"):
            row[path]["sum"] = sum(row[path].values())
        rows.append(row)
        log(f"[time] K5 crossover N={N}: small q {row['small']['q']:.4f} gate "
            f"{row['small']['gate']:.4f} (sum {row['small']['sum']:.4f}) ms; tile "
            f"q {row['tile']['q']:.4f} gate {row['tile']['gate']:.4f} (sum "
            f"{row['tile']['sum']:.4f}) ms; {'small' if row['small']['sum'] < row['tile']['sum'] else 'tile'} wins")
    wins = [r["N"] for r in rows if r["small"]["sum"] < r["tile"]["sum"]]
    pick = max([n for n in wins if 8 <= n <= 16], default=None)
    log(f"[time] K5 crossover: the small path wins at N in {wins}; the largest "
        f"N in 8..16 where it wins: {pick}; SMALL_N = {qm.SMALL_N}")
    return {"rows": rows, "small_wins_at": wins, "largest_win_8_16": pick}


CROSSOVER_NS = (1, 2, 4, 8, 12, 16, 24, 32)


def phase_k4_service_times(serve, kernels, smi):
    """K3 and K4 on the int4 service's pool (phase 9): its layer-0 cache at
    the lengths of its deepest step."""
    import torch

    from freeze_omni_tpu_torch.ops import attention as att

    pool = serve["pool"]
    kv = pool.state.cache.kv
    length = torch.tensor(serve["pool_lengths"], dtype=torch.int32, device="cuda")
    H = pool._dcfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(13)
    for entry in kernels:
        name = entry["name"].split(" ")[0]
        if name in ("decode_attention", "decode_attention_blocked"):
            r = decode_time(getattr(att, name), kv.k[0], kv.v[0], length, H, g)
            log_decode_time(name, f"service pool B={kv.k.shape[1]} "
                            f"S={kv.k.shape[2]} lengths {length.tolist()}", r, smi)
            entry["service_pool_shape"] = {k: r[k] for k in (
                "ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}


def phase_k5_times(serve, errs, smi):
    """K5 on the int4 server's layer-0 projections: a tick (N = 8 sessions
    x 29 tokens, the tile path) and text-decode steps (N = 1, 4, 8 and
    SMALL_N, the small-N path), then the crossover of the two paths."""
    import torch

    from freeze_omni_tpu_torch.ops import quant_matmul as qm

    engine = serve["server"].service.engine
    layers = engine.core.params["llm"]["layers"]
    B = engine.store.max_sessions
    g = torch.Generator(device="cuda").manual_seed(11)
    k5 = k5_layer(layers, B * 29, g)
    decode = {}
    for N in sorted({1, 4, 8, qm.SMALL_N}):
        t = k5_layer(layers, N, g)
        decode[f"decode_step_N{N}"] = {
            k: t.get(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "library_device_ms",
                                  "dense_bf16_ms", "library_error")}
        log(f"[time] K5 one layer's 7 projections at N={N} ({smi}): kernel "
            f"{t['ms']:.4f} ms eager, {t['device_ms']:.4f} ms device, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['bound_ms'] / t['ms']:.3f} "
            f"of eager, {t['bound_ms'] / t['device_ms']:.3f} of device), plain "
            f"{t['plain_ms']:.4f} ms, torch._weight_int4pack_mm {t['library_ms']} "
            f"ms eager, {t['library_device_ms']} ms device")
    log(f"[time] K5 one layer's 7 projections at N={B * 29} ({smi}): kernel "
        f"{k5['ms']:.4f} ms ({k5['device_ms']:.4f} device), bound "
        f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}), plain {k5['plain_ms']:.4f} "
        f"ms, torch._weight_int4pack_mm {k5['library_ms']} ms "
        f"({k5['library_device_ms']} device), dense bf16 matmul "
        f"{k5['dense_bf16_ms']:.4f} ms")
    crossover = k5_crossover(layers, g)
    launches = serve["launches"]
    return {"name": "quant_matmul4 (K5, one layer's 7 int4 projections at N=232)",
            "route": "cuda", "source": "freeze_omni_tpu_torch/csrc/quant_matmul4.cu",
            "replaces": "freeze_omni_tpu/ops/quant_matmul.py:162",
            "launches": launches["quant_matmul4"],
            "max_abs_err": errs["quant_matmul4"], "ms": k5["ms"],
            "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
            "library_error": k5.get("library_error"),
            "device_ms": k5["device_ms"], "library_device_ms": k5["library_device_ms"],
            "dense_bf16_ms": k5["dense_bf16_ms"],
            "launches_small": launches["quant_matmul4_small"],
            "launches_tile": launches["quant_matmul4"] - launches["quant_matmul4_small"],
            "max_abs_err_paths": errs["quant_matmul4_paths"],
            "small_n": qm.SMALL_N,
            "launches_int4_service": launches["quant_matmul4"],
            "launches_per_tick": serve["per_tick"]["quant_matmul4"],
            "launches_per_response": serve["per_response"]["quant_matmul4"],
            "launches_small_per_response": serve["per_response"]["quant_matmul4_small"],
            "card": smi, **decode, "crossover": crossover}


SESSION_ARGV = ["--preset", "flagship", "--respond", "--seed", "0"]


def session_windows(gating_cfg, audio, statuses):
    """Gated fbank windows [1, T, 80] of `audio` with per-chunk statuses,
    and each window's status for DuplexPipeline ('ipu_sl' / 'ipu_cl')."""
    from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, gate_stream

    items = gate_stream(GatingChunker(gating_cfg), audio, statuses)
    return [(f, "ipu_sl" if sl else "ipu_cl") for f, sl in items]


def phase_session_parity():
    """The per-session path, card against CPU, at flagship width with 2 LLM
    layers, int8 weights and the float bf16 KV the pipeline keeps: the same
    user and system windows through DuplexPipeline on both devices, then the
    first 8 text draws of DuplexResponder on the resulting context,
    teacher-forced on the CPU (SamplingTape)."""
    import numpy as np
    import torch

    from freeze_omni_tpu_torch.duplex.responder import DuplexResponder
    from freeze_omni_tpu_torch.models import audio_llm, qwen2
    from freeze_omni_tpu_torch.pipeline import DuplexPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parity_config()
    params = audio_llm.init_params(cfg.audio_llm, seed=3, device="cuda",
                                   quantize_llm=True, quant_bits=8)
    pipes = {"card": DuplexPipeline(cfg, params=params, device="cuda"),
             "cpu": DuplexPipeline(cfg, params=tree_to(params, "cpu"), device="cpu")}
    n = cfg.duplex.gating.samples_per_chunk
    rng = np.random.RandomState(5)
    user = session_windows(cfg.duplex.gating, np.concatenate([
        np.zeros(n, np.float32), 0.5 * speech_surrogate(rng, 4 * n)]),
        [None, "ipu_sl", "ipu_cl", "ipu_cl"])
    system = session_windows(cfg.duplex.gating, 0.5 * speech_surrogate(rng, 2 * n),
                             ["ipu_sl", "ipu_cl"])
    order = [("user", user[0]), ("user", user[1]), ("system", system[0]),
             ("user", user[2]), ("system", system[1]), ("user", user[3])]
    runs = {}
    for side, pl in pipes.items():
        kv = qwen2.copy_cache(pl.speech_dialogue(None, "", "pre")[1])
        if kv.k.dtype != torch.bfloat16:
            raise AssertionError(f"the per-session KV is {kv.k.dtype}, not bf16")
        caches = {"user": (None, None, 0), "system": (None, None, 0)}
        rows = []
        for identity, (feat, status) in order:
            c = caches[identity]
            pred, kv, adp, enc, pe = pl.speech_dialogue(
                feat, identity, status, past_key_values=kv, adapter_cache=c[0],
                encoder_cache=c[1], pe_index=c[2])
            caches[identity] = (adp, enc, pe)
            rows.append((pred, int(kv.length[0]), int(enc.pe_index[0])))
        runs[side] = (rows, kv)
    worst = 0.0
    for (pg, lg, eg), (pc, lc, ec) in zip(runs["card"][0], runs["cpu"][0]):
        if (lg, eg) != (lc, ec):
            raise AssertionError(f"KV length / pe_index {lg}/{eg} (card) vs "
                                 f"{lc}/{ec} (cpu)")
        if pg is None:
            continue
        for key in ("state_1", "state_2"):
            d = abs(pg[key] - pc[key])
            worst = max(worst, d)
            if not (np.isfinite(pg[key]) and d <= 5e-3):
                raise AssertionError(f"{key}: card {pg[key]} vs cpu {pc[key]}")
    tape = SamplingTape()
    lengths = {}
    for side, pl in pipes.items():
        # 1 + 7 draws: the first token and one segment of 7
        responder = DuplexResponder(pl.core, None, cfg, max_tokens=8, segment=7)
        responder.speak = lambda text, hiddens: None   # text only, no synthesis
        kv = runs[side][1]
        with tape.attached(replay=side == "cpu"):
            sentences = list(responder.respond(kv))
        lengths[side] = (int(kv.length[0]), len(sentences))
    if tape.pos != len(tape.tokens) or tape.stats["text"]["draws"] != 8:
        raise AssertionError(f"replayed {tape.pos} of {len(tape.tokens)} draws "
                             f"({tape.stats['text']['draws']} text draws, want 8)")
    if lengths["card"] != lengths["cpu"]:
        raise AssertionError(f"after the response: (KV length, sentences) "
                             f"{lengths['card']} (card) vs {lengths['cpu']} (cpu)")
    st = tape.stats["text"]
    log(f"[session-parity] DuplexPipeline, 2-layer flagship widths, int8 "
        f"weights, bf16 KV: {len(order)} chunks (user ipu_sl/ipu_cl, system "
        f"ipu_sl/ipu_cl): card vs cpu max |dprob| {worst:.3e} (atol 5e-3); KV "
        f"lengths {[r[1] for r in runs['card'][0]]} and pe_index equal; "
        f"DuplexResponder's first 8 text draws teacher-forced on the cpu: "
        f"{st['flips']} near-tie flips (worst gap {st['worst_gap']:.3e}, margin "
        f"{TIE_FRAC}); KV length and sentences after the response "
        f"{lengths['card']} on both")
    return worst


def phase_sessions(smi):
    """The per-session path at full width and depth: the port's Server
    without --engine (SESSION_ARGV: int8 weights, bf16 frontend and KV, one
    DuplexResponder over a StreamingTTS) and two DuplexSessions on its
    pipeline, each pumping on its own worker thread as two websocket clients
    get them (Server._open_session: warm-up, then start)."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.bin.serve import Server, get_args
    from freeze_omni_tpu_torch.duplex.events import EventSink
    from freeze_omni_tpu_torch.models import qwen2

    torch.backends.cudnn.allow_tf32 = True   # serving default
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = Server(get_args(SESSION_ARGV))
    if server.service is not None or server.responder is None:
        raise AssertionError("the server did not take the per-session path")
    pipeline, responder, cfg = server.pipeline, server.responder, server.cfg
    # the sentence budget cut as in phase 7; random-weight text decodes to
    # nothing, so each spoken sentence takes a fixed text, its prefix the
    # response's own hiddens, through the responder's own synthesis step
    responder.tts.cfg = dataclasses.replace(cfg.tts, max_tokens=TTS_MAX_TOKENS)
    texts, count = fixed_sentences(), itertools.count()

    def synthesize(tokens, hiddens):
        text = texts[next(count) % len(texts)]
        return text, responder.speak(text, hiddens)

    responder._synthesize = synthesize
    role = pipeline.core.role_kv(cfg.duplex.default_prompt)
    role_before = qwen2.copy_cache(role)
    torch.cuda.synchronize()
    log(f"[session] Server({' '.join(SESSION_ARGV)}) built in "
        f"{time.perf_counter() - t0:.1f} s; role prefill {int(role.length[0])} "
        f"slots of {role.k.shape[2]}, {role.k.dtype}")

    sids = ["c0", "c1"]
    sinks = {sid: EventSink() for sid in sids}
    marks = {sid: {} for sid in sids}
    for sid in sids:
        def mark(name, sid=sid):
            def on(_):
                marks[sid].setdefault(name, time.perf_counter())
            return on
        sinks[sid].on("dialog_ss_callback", mark("dialog_ss"))
        sinks[sid].on("response_audio", mark("audio"))
    t0 = time.perf_counter()
    sessions = {sid: server._open_session(sid, sinks[sid]) for sid in sids}
    open_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # predictions stay below threshold until the session's first user IPU
    # has closed; its next decision speaks, the rest do not
    predict_ms, lock = {"before": [], "after": []}, threading.Lock()
    for sid, sess in sessions.items():
        sess.resp_threshold = 2.0

        def on_vad(e, sess=sess, sid=sid):
            if e["identity"] == "user" and e["status"] == "ipu_el" \
                    and "dialog_ss" not in marks[sid]:
                sess.resp_threshold = 0.0
        sinks[sid].on("vad_event", on_vad)
        sinks[sid].on("dialog_ss_callback",
                      lambda _, sess=sess: setattr(sess, "resp_threshold", 2.0))
        real = sess._predict_stage

        def timed(feat, real=real, sid=sid):
            # until the chunk's work is done on the card; the sessions share
            # one stream, so this includes the other session's work queued
            # ahead of it, as the session feels it
            spoke = "dialog_ss" in marks[sid]
            t = time.perf_counter()
            real(feat)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            if spoke == ("dialog_ss" in marks[sid]):   # no response inside
                with lock:
                    any_ss = any("dialog_ss" in m for m in marks.values())
                    predict_ms["after" if any_ss else "before"].append(
                        (time.perf_counter() - t) * 1e3)
        sess._predict_stage = timed

    heads = cfg.audio_llm.llm.num_heads
    calls = {"text decode": 0, "StreamingTTS": 0}
    last_len = {}
    real_decode = qwen2.gqa_decode

    def recorded(q, k, v, length):
        kind = "text decode" if q.shape[1] == heads else "StreamingTTS"
        with lock:
            calls[kind] += 1
            last_len[kind] = (tuple(k.shape), length.clone())
        return real_decode(q, k, v, length)

    n = cfg.duplex.gating.samples_per_chunk
    chunk_s = n / 16000   # the clients stream in real time, a 224 ms chunk each
    users = [np.concatenate([np.zeros((1 + i) * n, np.float32),
                             0.5 * speech_surrogate(np.random.RandomState(200 + i), 24000),
                             np.zeros(24000, np.float32),
                             0.5 * speech_surrogate(np.random.RandomState(300 + i), 48000),
                             np.zeros(32000, np.float32)]) for i in range(len(sids))]
    rng = np.random.RandomState(1)
    torch.cuda.synchronize()
    qwen2.gqa_decode = recorded
    zero_launches()
    t_run = time.perf_counter()
    try:
        steps = max(len(u) for u in users) // n + 1
        for k in range(steps):
            for i, sid in enumerate(sids):
                chunk = users[i][k * n:(k + 1) * n]
                sessions[sid].enqueue_audio_data("user", {"audio": np.concatenate(
                    [chunk, np.zeros(n - len(chunk), np.float32)]), "enc": "f32"})
                sessions[sid].enqueue_audio_data("system", {
                    "audio": (LINE_NOISE * rng.randn(n)).astype(np.float32),
                    "enc": "f32"})
            time.sleep(max(0.0, t_run + (k + 1) * chunk_s - time.perf_counter()))

        def settled():
            for sid, sess in sessions.items():
                if sinks[sid].events_of("error"):
                    raise AssertionError(f"{sid}: {sinks[sid].events_of('error')}")
                fe = sess.frontend
                heard = [e for e in sinks[sid].events_of("vad_event")
                         if e["identity"] == "system"]
                busy = any(q.available() >= n for q in fe.pcm.values()) \
                    or len(fe.serializer)
                if busy or "audio" not in marks[sid] or not heard:
                    return False
            return True

        deadline = time.perf_counter() + 240
        while not settled():
            if time.perf_counter() > deadline:
                raise AssertionError("the sessions did not settle in 240 s")
            time.sleep(0.1)
        time.sleep(1.0)   # the system IPU's last windows
        for sess in sessions.values():
            sess.release()
        torch.cuda.synchronize()
    finally:
        qwen2.gqa_decode = real_decode
        for sess in sessions.values():
            sess.release()
    run_s = time.perf_counter() - t_run
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    sessions[sids[0]].reset_context()
    torch.cuda.synchronize()
    for name, a, b in zip(qwen2.KVCache._fields, role, role_before):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"the role prefill's {name} changed")
    if int(sessions[sids[0]].past_key_values.length[0]) != int(role.length[0]):
        raise AssertionError("reset_context did not restart from the role prefill")
    for sid in sids:
        ev = sinks[sid]
        st = [e["status"] for e in ev.events_of("vad_event") if e["identity"] == "user"]
        if "ipu_sl" not in st or "ipu_el" not in st:
            raise AssertionError(f"{sid}: user VAD events {st}")
        upd = ev.events_of("dialog_state_update")
        if not upd or not all(np.isfinite([u["probs"]["state_1"],
                                           u["probs"]["state_2"]]).all() for u in upd):
            raise AssertionError(f"{sid}: no finite dialog_state_update")
        if ev.events_of("error"):
            raise AssertionError(f"{sid}: error events {ev.events_of('error')}")
        for a in ev.events_of("response_audio"):
            if not (np.isfinite(a["pcm"]).all() and np.abs(a["pcm"]).max(initial=0.0) <= 1.0):
                raise AssertionError(f"{sid}: response PCM not finite or outside [-1, 1]")
    for key in ("quant_matmul", "decode_attention_blocked"):
        if launches[key] <= 0:
            raise AssertionError(f"{key} was not launched on the per-session path")
    for key in ("prefill_quant", "decode_attention", "quant_matmul4"):
        if launches[key]:
            raise AssertionError(f"{key} launched {launches[key]} times on the "
                                 f"per-session path (float KV, int8 weights)")
    for kind, c in calls.items():
        if not c:
            raise AssertionError(f"K4 was not reached from the {kind}")
    lat = {sid: (marks[sid]["audio"] - marks[sid]["dialog_ss"]) * 1e3 for sid in sids}
    seconds = {sid: round(sum(a["pcm"].shape[-1] for a in sinks[sid].events_of(
        "response_audio")) / 16000, 3) for sid in sids}
    lengths = {kind: (shape, ln.tolist()) for kind, (shape, ln) in last_len.items()}
    log(f"[session] ({smi}) 2 sessions opened (construction + warm-up) in "
        f"{open_s:.2f} s; streamed and settled in {run_s:.2f} s")
    for when, label in (("before", "before either session spoke"),
                        ("after", "once a response had started")):
        log(f"[session] _predict_stage per chunk {label} (both sessions' "
            f"workers, both identities, synchronized; {len(predict_ms[when])} "
            f"chunks) {pct(predict_ms[when]) if predict_ms[when] else 'none'} "
            f"against {BUDGET_MS:.0f} ms")
    log(f"[session] dialog_ss to the first response_audio (the whole first "
        f"sentence: text decode, then StreamingTTS with max_tokens "
        f"{TTS_MAX_TOKENS}) ms {[round(lat[s], 2) for s in sids]}; audio per "
        f"session (s) {seconds}; the system VAD heard the feedback in both")
    log(f"[session] peak device memory while building the server and the "
        f"sessions {build_peak / 2**30:.2f} GiB (the int8 draw), while serving "
        f"{peak / 2**30:.2f} GiB; launches "
        f"{launches}; K4 calls by caller {calls} (K4 launches "
        f"{launches['decode_attention_blocked']}); the last K4 call's cache "
        f"shape and length by caller {lengths}; role prefill unchanged after "
        f"both sessions and a reset")
    return {"server": server, "launches": launches, "k4_calls": calls,
            "k4_lengths": lengths}


def phase_session_one_caller(server, smi):
    """Where a per-session chunk's time goes, on the server's pipeline with
    one caller: user windows of the speech surrogate straight into
    DuplexPipeline.speech_dialogue (no VAD, no gating on the clock; the call
    fetches its probabilities, so it ends synchronized), one text-decode step
    at B = 1, and torch.profiler over 4 chunks: the kernels' time over the
    wall (the device's busy share) and the host operators with the most self
    time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from freeze_omni_tpu_torch.models import audio_llm, qwen2

    pipeline, cfg = server.pipeline, server.cfg
    core = pipeline.core
    n = cfg.duplex.gating.samples_per_chunk
    windows = session_windows(cfg.duplex.gating, 0.5 * speech_surrogate(
        np.random.RandomState(400), 17 * n), ["ipu_sl"] + ["ipu_cl"] * 16)

    def run(items, out_ms):
        kv = qwen2.copy_cache(pipeline.speech_dialogue(None, "", "pre")[1])
        state = (None, None, 0)
        for feat, status in items:
            t = time.perf_counter()
            _, kv, adp, enc, pe = pipeline.speech_dialogue(
                feat, "user", status, past_key_values=kv, adapter_cache=state[0],
                encoder_cache=state[1], pe_index=state[2])
            out_ms.append((time.perf_counter() - t) * 1e3)
            state = (adp, enc, pe)
        return kv

    chunk_ms = []
    kv = run(windows, chunk_ms)
    tok, step_ms = core._ids([7]), []
    with torch.no_grad():
        for _ in range(11):
            t = time.perf_counter()
            tok, _, _ = audio_llm.generate_step(core.params, cfg.audio_llm, tok, kv,
                                                core.next_key(), cfg.sampling)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(windows[:4], [])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernel_ms = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    log(f"[session-one] ({smi}) one caller, a user chunk ({len(chunk_ms) - 1} "
        f"after the first) {pct(chunk_ms[1:])}; a text-decode step at B = 1 "
        f"(10 after the first, synchronized) {pct(step_ms[1:])}")
    log(f"[session-one] profiled 4 chunks: wall {wall_ms:.2f} ms, kernels "
        f"{kernel_ms:.2f} ms, device busy share {kernel_ms / wall_ms:.3f}; top "
        f"host self time: " + "; ".join(
            f"{e.key} {e.count} calls {e.self_cpu_time_total / 1e3:.2f} ms"
            for e in top))


def phase_session_kernel_times(sess, kernels, smi):
    """K1 and K4 at the per-session path's B = 1 shapes, on the server's
    int8 layer-0 weights: K1's 7 projections at N = 1 with the lm_head
    (text decode) and at each chunk's N; K4 at the text decode's and
    StreamingTTS's cache shapes with the last lengths the run gave them."""
    import torch

    from freeze_omni_tpu_torch.ops import attention as att

    llm = sess["server"].pipeline.core.params["llm"]
    g = torch.Generator(device="cuda").manual_seed(17)
    k1 = {"decode_N1_with_lm_head": k1_layer(llm["layers"], llm["lm_head"], 1, g)}
    for N in session_chunk_ns():
        k1[f"chunk_N{N}"] = k1_layer(llm["layers"], None, N, g)
    for label, t in k1.items():
        log(f"[time] K1 per-session {label} ({smi}): kernel {t['ms']:.4f} ms "
            f"eager, {t['device_ms']:.4f} ms device, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
            f"torch._weight_int8pack_mm {t['library_ms']:.4f} ms, dense bf16 "
            f"matmul {t['dense_bf16_ms']:.4f} ms")
    k4 = {}
    for kind, (shape, length) in sess["k4_lengths"].items():
        _, S, Hkv, dk = shape
        H = 28 if kind == "text decode" else 14
        dtype = torch.bfloat16 if kind == "text decode" else torch.float32
        k = torch.randn((1, S, Hkv, dk), generator=g, device="cuda").to(dtype)
        v = torch.randn((1, S, Hkv, dk), generator=g, device="cuda").to(dtype)
        ln = torch.tensor(length, dtype=torch.int32, device="cuda")
        k4[kind] = decode_time(att.decode_attention_blocked, k, v, ln, H, g)
        k4[kind]["splits"] = att.decode_plan(1, H, Hkv, dk, S).splits
        k4[kind]["length"] = length
        log_decode_time("decode_attention_blocked", f"per-session {kind} B=1 "
                        f"S={S} H={H} Hkv={Hkv} dk={dk} length {length}, "
                        f"{k4[kind]['splits']} splits", k4[kind], smi)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "dense_bf16_ms")
    for entry in kernels:
        name = entry["name"].split(" ")[0]
        entry["launches_per_session_path"] = sess["launches"][name]
        entry["launches"] += sess["launches"][name]
        if name == "quant_matmul":
            entry["per_session"] = {lbl: {k: t[k] for k in keys}
                                    for lbl, t in k1.items()}
        if name == "decode_attention_blocked":
            entry["per_session"] = {kind: {k: r[k] for k in (
                "ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "splits", "length")}
                for kind, r in k4.items()}
            entry["per_session_calls"] = sess["k4_calls"]


# ---------------------------------------------------------------------------
# phase 11: checkpoints, the offline CLI and the eval harnesses
# ---------------------------------------------------------------------------

TINY_COPY = os.path.join("freeze_omni_tpu_torch", "assets", "tiny_s2s")
TINY_DATA = os.path.join("freeze_omni_tpu", "assets", "tiny_s2s")
CER_MAX, QA_MIN = 3.74, 93.75   # QUALITY.json's 2.74 plus one point; 15 of 16
REFERENCE_LAYERS = 2            # the 7B-width reference checkpoint's depth
# K4's timed shape for the tiny StreamingTTS: slots visible near the end of
# the offline turn's sentence (bos, ~16 text frames, ~12 hidden frames, ~10
# codec tokens)
TINY_TTS_VISIBLE = 40

_ST_DTYPES = {"torch.float32": "F32", "torch.bfloat16": "BF16",
              "torch.float16": "F16", "torch.int8": "I8", "torch.uint8": "U8",
              "torch.int32": "I32", "torch.int64": "I64"}


def write_safetensors(path, tensors):
    """A minimal safetensors writer: the 8-byte little-endian header length,
    the JSON header (padded with spaces to 8 bytes), then each tensor's raw
    bytes in order (the host is little-endian)."""
    import torch

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                    .numpy().data)


def _unstack(tree, i):
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _ref_linear(sd, name, p):
    sd[f"{name}.weight"] = p["w"].T.contiguous()   # ours [in, out] -> [out, in]
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def _ref_norm(sd, name, p):
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    for k, v in p.items():
        sd[f"{name}.{names[k]}"] = v


def _ref_conv(sd, name, p):
    sd[f"{name}.weight"] = p["w"]
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def _ref_llama(sd, name, p):
    _ref_norm(sd, f"{name}.input_layernorm", p["ln1"])
    _ref_norm(sd, f"{name}.post_attention_layernorm", p["ln2"])
    for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                         ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                         ("down", "mlp.down_proj")):
        _ref_linear(sd, f"{name}.{theirs}", p[ours])


def reference_state_dicts(params, tts, num_blocks, num_llm_layers):
    """The port's trees under the reference's names (the inverse of
    utils/checkpoint.py's converters, for the weights the port draws):
    (audiollm final.pt, HF Qwen2 state dict, decoder final.pt, codec
    final.pt's {generator, quantizer})."""
    am = {}
    for who in ("user", "system"):
        p, pre = params[f"encoder_{who}"], f"encoder_{who}."
        am[f"{pre}global_cmvn.mean"] = p["cmvn"]["mean"]
        am[f"{pre}global_cmvn.istd"] = p["cmvn"]["istd"]
        sub = f"{pre}enc.0.core"
        _ref_conv(am, f"{sub}.conv.0", p["sub"]["conv1"])
        _ref_conv(am, f"{sub}.conv.2", p["sub"]["conv2"])
        _ref_linear(am, f"{sub}.out.0", p["sub"]["out"])
        _ref_linear(am, f"{pre}enc.1.embed.0", p["embed"]["lin"])
        _ref_norm(am, f"{pre}enc.1.embed.1", p["embed"]["ln"])
        _ref_norm(am, f"{pre}enc.1.after_norm", p["after_norm"])
        for i in range(num_blocks):
            blk, b = _unstack(p["blocks"], i), f"{pre}enc.1.encoders.{i}"
            _ref_norm(am, f"{b}.norm1", blk["ln1"])
            _ref_norm(am, f"{b}.norm2", blk["ln2"])
            for ours, theirs in (("q", "linear_q"), ("k", "linear_k"),
                                 ("v", "linear_v"), ("o", "linear_out"),
                                 ("pos", "linear_pos")):
                _ref_linear(am, f"{b}.self_attn.{theirs}", blk[ours])
            am[f"{b}.self_attn.pos_bias_u"] = blk["bias_u"]
            am[f"{b}.self_attn.pos_bias_v"] = blk["bias_v"]
            _ref_linear(am, f"{b}.feed_forward.w_1", blk["ffn1"])
            _ref_linear(am, f"{b}.feed_forward.w_2", blk["ffn2"])
        a, pre = params[f"adapter_{who}"], f"adpter_{who}."
        _ref_conv(am, f"{pre}conv1d1", a["conv1"])
        _ref_norm(am, f"{pre}bn1", a["bn1"])
        _ref_conv(am, f"{pre}conv1d2", a["conv2"])
        _ref_norm(am, f"{pre}bn2", a["bn2"])
        _ref_linear(am, f"{pre}project", a["proj"])
    _ref_linear(am, "predictor_head", params["predictor"])
    am["task_embeddings.weight"] = params["task_embeddings"]

    llm = params["llm"]
    hf = {"model.embed_tokens.weight": llm["embed"]["w"],
          "model.norm.weight": llm["final_norm"]["scale"],
          "lm_head.weight": llm["lm_head"]["w"].T.contiguous()}
    for i in range(num_llm_layers):
        _ref_llama(hf, f"model.layers.{i}", _unstack(llm["layers"], i))

    dec = tts["decoder"]
    ds = {"embedding.weight": dec["embedding"]["w"],
          "norm.weight": dec["final_norm"]["scale"]}
    _ref_linear(ds, "out_fnn", dec["out"])
    for group, name in (("pre_nn", "layers_pre_nn"), ("layers", "layers"),
                        ("prefix", "layers_prefix")):
        if group in dec:
            for i in range(dec[group]["ln1"]["scale"].shape[0]):
                _ref_llama(ds, f"{name}.{i}", _unstack(dec[group], i))

    g = tts["codec"]["generator"]
    gen = {}
    _ref_conv(gen, "conv_pre", g["conv_pre"])
    _ref_conv(gen, "conv_post", g["conv_post"])
    for i, up in enumerate(g["ups"]):
        _ref_conv(gen, f"ups.{i}", up)
    for i, rb in enumerate(g["resblocks"]):
        for grp in ("convs1", "convs2"):
            for j, c in enumerate(rb[grp]):
                _ref_conv(gen, f"resblocks.{i}.{grp}.{j}", c)
    q = tts["codec"]["quantizer"]
    quant = {}
    for layer, base in zip(q["codebooks"], ("quantizer_modules", "quantizer_modules2",
                                            "quantizer_modules3", "quantizer_modules4")):
        for gi in range(layer.shape[0]):
            quant[f"{base}.{gi}.embedding.weight"] = layer[gi]
    for gi in range(q["gst"].shape[0]):
        quant[f"quantizer_modules_globaltokens.{gi}.embedding.weight"] = q["gst"][gi]
    return am, hf, ds, {"generator": gen, "quantizer": quant}


def write_reference_checkpoint(root, cfg, seed, device="cuda",
                               llm_dtype=None):
    """A reference-format checkpoint of `cfg` with seeded random weights (the
    port's own initializers, drawn on `device`), as the reference ships one:
    `<root>/ckpt/audiollm/{train.yaml, final.pt, global_cmvn}`,
    `<root>/ckpt/decoder/{model.json, final.pt}`,
    `<root>/ckpt/codec/{model.json, final.pt}` and the HF Qwen2 dir
    `<root>/llm/{config.json, model.safetensors}` (the LLM in `llm_dtype`,
    bf16 by default, as Qwen2-7B-Instruct ships). train.yaml is written as
    JSON, which is YAML. Returns (model_path, llm_path)."""
    import dataclasses

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.models import codec as codec_mod
    from freeze_omni_tpu_torch.models import speech_decoder as sd_mod

    llm_dtype = llm_dtype or torch.bfloat16
    acfg, enc, llm = cfg.audio_llm, cfg.audio_llm.encoder, cfg.audio_llm.llm
    params = audio_llm.init_params(acfg, seed=seed, device=device,
                                   llm_dtype=llm_dtype)
    # init_params draws an identity CMVN; the stats file below gives another
    rng = np.random.RandomState(seed)
    frames = rng.randn(500, enc.input_dim) * 2 + 1
    mean = frames.mean(0)
    istd = 1.0 / np.sqrt(np.maximum((frames ** 2).mean(0) - mean ** 2, 1e-20))
    for who in ("encoder_user", "encoder_system"):
        params[who]["cmvn"] = {
            "mean": torch.tensor(mean, dtype=torch.float32, device=device),
            "istd": torch.tensor(istd, dtype=torch.float32, device=device)}
    g = torch.Generator(device=device).manual_seed(seed + 7)
    tts = {"decoder": sd_mod.init_params(cfg.tts.decoder, g, device=device),
           "codec": codec_mod.init_params(cfg.tts.codec, g, device=device)}
    am, hf, ds, cs = reference_state_dicts(params, tts, enc.num_blocks,
                                           llm.num_layers)
    del params, tts
    cpu = lambda d: {k: (cpu(v) if isinstance(v, dict) else v.cpu())  # noqa: E731
                     for k, v in d.items()}

    model_path, llm_path = os.path.join(root, "ckpt"), os.path.join(root, "llm")
    for sub in ("audiollm", "decoder", "codec"):
        os.makedirs(os.path.join(model_path, sub))
    os.makedirs(llm_path)
    torch.save(cpu(am), os.path.join(model_path, "audiollm", "final.pt"))
    train = {
        "input_dim": enc.input_dim, "is_json_cmvn": True,
        "encoder_conf": {
            "overview_conf": {"encoder-layer-config": "subsampling-transformer",
                              "encoder-input-dim": enc.input_dim,
                              "encoder-output-dim": enc.output_dim},
            "para_conf": {
                "subsampling": {"subsampling-rate": enc.subsampling_rate,
                                "subsampling-input-dim": enc.input_dim,
                                "subsampling-output-dim": enc.attention_dim},
                "transformer": {
                    "transformer-attention-dim": enc.attention_dim,
                    "transformer-attention-heads": enc.attention_heads,
                    "transformer-linear-units": enc.linear_units,
                    "transformer-num-blocks": enc.num_blocks,
                    "transformer-chunk_size": enc.chunk_size,
                    "transformer-left_chunks": enc.left_chunks,
                    "transformer-pos-enc-class": enc.pos_enc,
                    "transformer-input-dim": enc.attention_dim,
                    "transformer-output-dim": enc.output_dim}}},
        "model_conf": {"enc_out_dim": acfg.adapter.enc_out_dim,
                       "llm_embed_dim": llm.hidden,
                       "kernel_size": acfg.adapter.kernel_size,
                       "activation_func": acfg.adapter.activation,
                       "norm": acfg.adapter.norm, "adpter_type": "subsampling",
                       "llm_head_num": llm.num_heads,
                       "num_key_value_heads": llm.num_kv_heads,
                       "predict_usr_state": acfg.num_states}}
    with open(os.path.join(model_path, "audiollm", "train.yaml"), "w") as f:
        json.dump(train, f, indent=1)
    with open(os.path.join(model_path, "audiollm", "global_cmvn"), "w") as f:
        json.dump({"mean_stat": frames.sum(0).tolist(),
                   "var_stat": (frames ** 2).sum(0).tolist(),
                   "frame_num": len(frames)}, f)
    dcfg = cfg.tts.decoder
    torch.save(cpu(ds), os.path.join(model_path, "decoder", "final.pt"))
    with open(os.path.join(model_path, "decoder", "model.json"), "w") as f:
        json.dump([dcfg.idim, dcfg.codec_vocab, {
            "transformer_attention_dim": dcfg.hidden,
            "transformer_num_blocks": dcfg.num_layers,
            "transformer_attention_heads": dcfg.num_heads,
            "transformer_linear_units": dcfg.ffn,
            "kv_cache_prefix_finetune": int(dcfg.use_prefix_kv)}], f)
    torch.save(cpu(cs), os.path.join(model_path, "codec", "final.pt"))
    with open(os.path.join(model_path, "codec", "model.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg.tts.codec), f)
    with open(os.path.join(llm_path, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
                   "hidden_size": llm.hidden, "intermediate_size": llm.ffn,
                   "num_attention_heads": llm.num_heads,
                   "num_hidden_layers": llm.num_layers,
                   "num_key_value_heads": llm.num_kv_heads,
                   "vocab_size": llm.vocab_size, "rms_norm_eps": llm.rms_eps,
                   "rope_theta": llm.rope_theta,
                   "tie_word_embeddings": llm.tie_embeddings,
                   "torch_dtype": str(llm_dtype).replace("torch.", "")}, f)
    write_safetensors(os.path.join(llm_path, "model.safetensors"), hf)
    return model_path, llm_path


def _abs_manifest(src, out_dir):
    """A copy of a committed manifest whose wav paths are absolute (they are
    written relative to the repository's root)."""
    root = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(out_dir, os.path.basename(src))
    with open(os.path.join(root, src)) as f, open(dst, "w") as g:
        for line in f:
            if line.strip():
                path, rest = line.rstrip("\n").split("\t", 1)
                g.write(f"{os.path.join(root, path)}\t{rest}\n")
    return dst


def _harness(main_fn, argv):
    """One eval harness's main on the card: (its result, wall seconds). The
    hypotheses go to stderr, the JSON line to stdout."""
    import torch

    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        result = main_fn(argv)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t


def phase_trained_tiny(smi):
    """11a and 11b: the committed trained tiny system, read through the
    port's chunk index, scored on the card by the eval harnesses; one batch of 8 ASR
    utterances card against CPU; the serial stage machine on 2; the offline
    CLI's one turn, its text held to the CPU's. TF32 off, as in a parity
    phase."""
    import argparse
    import dataclasses
    import functools
    import tempfile

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.bin import asr_eval, offline_infer, qa_eval
    from freeze_omni_tpu_torch.frontend.chunker import OfflineChunker
    from freeze_omni_tpu_torch.pipeline import InferencePipeline
    from freeze_omni_tpu_torch.utils.factory import load_native_system
    from freeze_omni_tpu_torch.utils.logging import reset_spans

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    copy = os.path.join(root, TINY_COPY)
    with open(os.path.join(root, TINY_DATA, "QUALITY.json")) as f:
        quality = json.load(f)
    with tempfile.TemporaryDirectory(prefix="tiny_eval_") as tmp:
        asr_tsv = _abs_manifest(os.path.join(TINY_DATA, "asr_dev.tsv"), tmp)
        qa_tsv = _abs_manifest(os.path.join(TINY_DATA, "qa_dev.tsv"), tmp)
        zero_launches()
        asr, asr_s = _harness(asr_eval.main, [
            "--model_path", copy, "--manifest", asr_tsv, "--char_level",
            "--batch", "8", "--max_tokens", "24"])
        qa, qa_s = _harness(qa_eval.main, [
            "--model_path", copy, "--manifest", qa_tsv, "--batch", "8",
            "--max_tokens", "12"])
        launches = read_launches()   # counted on through 11b
        with open(asr_tsv) as f:
            rows = [line.rstrip("\n").split("\t", 1) for line in f][:8]
    log(f"[tiny-eval] ({smi}) the trained tiny system from {TINY_COPY}, TF32 "
        f"off: ASR CER {asr['value']:.2f} % on {asr['n_utts']} utterances "
        f"(QUALITY.json {quality['asr_cer_pct']:.2f}; bound {CER_MAX}) in "
        f"{asr_s:.2f} s wall; QA accuracy {qa['value']:.2f} % on {qa['n_utts']} "
        f"(QUALITY.json {quality['qa_accuracy_pct']:.2f}; bound {QA_MIN}; "
        f"exact match {qa['detail']['exact_match']:.2f}, F1 "
        f"{qa['detail']['f1']:.2f}) in {qa_s:.2f} s wall; launches {launches}")
    if asr["n_utts"] != 24 or asr["value"] > CER_MAX:
        raise AssertionError(f"card ASR {asr} (CER bound {CER_MAX})")
    if qa["n_utts"] != 16 or qa["value"] < QA_MIN:
        raise AssertionError(f"card QA {qa} (accuracy bound {QA_MIN})")
    if launches["decode_attention_blocked"] == 0:
        raise AssertionError("the tiny system's text decode launched no K4")

    sides = (("card", "cuda"), ("cpu", "cpu"))
    pipes, tts = {}, {}
    for side, dev in sides:
        cfg, params, tts[side], tok = load_native_system(copy, device=dev)
        cfg = dataclasses.replace(
            cfg, sampling=dataclasses.replace(cfg.sampling, top_k=1),
            tts=dataclasses.replace(cfg.tts, top_k=1))
        pipes[side] = InferencePipeline(cfg, params=params, tokenizer=tok,
                                        device=dev)
    wavs = [asr_eval.load_wav(p) for p, _ in rows]
    hyps = {side: asr_eval.batched_transcribe(pl, cfg, wavs, 24)
            for side, pl in pipes.items()}
    differ = [(ref, hyps["card"][i], hyps["cpu"][i])
              for i, (_, ref) in enumerate(rows)
              if hyps["card"][i] != hyps["cpu"][i]]
    serial = {side: [asr_eval.transcribe(pl, OfflineChunker(cfg.chunker), w, 24)
                     for w in wavs[:2]] for side, pl in pipes.items()}
    log(f"[tiny-eval] one batch of 8 ASR utterances, card vs cpu: "
        f"{len(differ)} of 8 hypotheses differ"
        + "".join(f"; ref {r!r}: card {c!r}, cpu {h!r}" for r, c, h in differ)
        + f"; the serial stage machine on 2: card {serial['card']}, cpu "
        f"{serial['cpu']} ({sum(a != b for a, b in zip(*serial.values()))} differ)")

    text, pcm = {}, {}
    # greedy speech too: synthesize_sentence's own decoder_topk (2, as the
    # reference's) overrides cfg.tts.top_k
    synthesize = offline_infer.synthesize_sentence
    offline_infer.synthesize_sentence = functools.partial(synthesize,
                                                          decoder_topk=1)
    with tempfile.TemporaryDirectory(prefix="offline_") as tmp:
        for side, dev in sides:
            args = argparse.Namespace(
                input_wav=os.path.join(root, TINY_DATA, "dev_wavs", "qa_000.wav"),
                output_wav=os.path.join(tmp, f"{side}.wav"), max_tokens=24,
                seed=0, model_path=None, voice_wav=None, device=dev)
            reset_spans()
            before = read_launches()
            t = time.perf_counter()
            text[side], pcm[side] = offline_infer.run_inference(
                pipes[side].cfg, args, pipeline=pipes[side], tts_params=tts[side])
            seconds = time.perf_counter() - t
            after = read_launches()
            log(f"[offline] ({smi}) {side}: text {text[side]!r}, "
                f"{pcm[side].shape[0]} samples at 24 kHz in {seconds:.2f} s wall; "
                f"launches {({k: after[k] - before[k] for k in after})}")
    offline_infer.synthesize_sentence = synthesize
    if text["card"] != text["cpu"] or not text["card"].strip():
        raise AssertionError(f"offline text: card {text['card']!r}, cpu "
                             f"{text['cpu']!r}")
    if not (np.isfinite(pcm["card"]).all() and pcm["card"].shape[0] > 1):
        raise AssertionError("the offline CLI's PCM is empty or not finite")
    launches = read_launches()
    log(f"[tiny-eval] launches in 11a and 11b: {launches}")
    if launches["decode_attention_blocked"] == 0:
        raise AssertionError("11a/11b launched no K4")

    # K4 at the tiny speech decoder's shape (head dim 32), as StreamingTTS
    # calls it in the offline turn (B = 1, 4 heads, its 256-slot cache)
    from freeze_omni_tpu_torch.ops import attention as att

    dcfg = pipes["card"].cfg.tts.decoder
    H, dk, S = dcfg.num_heads, dcfg.hidden // dcfg.num_heads, dcfg.max_kv_len
    g = torch.Generator(device="cuda").manual_seed(23)
    k = torch.randn((1, S, H, dk), generator=g, device="cuda")
    v = torch.randn((1, S, H, dk), generator=g, device="cuda")
    length = torch.tensor([TINY_TTS_VISIBLE], dtype=torch.int32, device="cuda")
    k4 = decode_time(att.decode_attention_blocked, k, v, length, H, g)
    k4["splits"] = att.decode_plan(1, H, H, dk, S).splits
    k4["length"] = TINY_TTS_VISIBLE
    log_decode_time("decode_attention_blocked", f"tiny StreamingTTS B=1 S={S} "
                    f"H={H} Hkv={H} dk={dk} f32, {TINY_TTS_VISIBLE} visible, "
                    f"{k4['splits']} splits", k4, smi)
    torch.backends.cudnn.allow_tf32 = True   # serving default
    return {"cer": asr["value"], "qa": qa["value"], "differ": len(differ),
            "launches": launches, "k4_tiny_tts": k4}


def phase_reference_checkpoint(smi):
    """11c: a reference-format checkpoint at Qwen2-7B width (2 LLM layers,
    seeded random weights) written to a temporary directory, loaded with
    build_system_from_reference(quantize_llm_bits=8) onto the card, one
    offline turn, then served by bin/serve's Server (--model_path,
    --llm_path) with one DuplexSession answering a reset and user chunks."""
    import argparse
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.bin import offline_infer
    from freeze_omni_tpu_torch.bin.serve import Server, get_args
    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.duplex.engine import DuplexSession
    from freeze_omni_tpu_torch.duplex.events import EventSink
    from freeze_omni_tpu_torch.pipeline import InferencePipeline
    from freeze_omni_tpu_torch.utils.factory import build_system_from_reference
    from freeze_omni_tpu_torch.utils.logging import reset_spans

    base = flagship_system()
    cfg = dataclasses.replace(base, audio_llm=dataclasses.replace(
        base.audio_llm, llm=dataclasses.replace(base.audio_llm.llm,
                                                num_layers=REFERENCE_LAYERS)))
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ref7b_")
    try:
        du = shutil.disk_usage(tmp)
        log(f"[reference] {tmp}: {du.free / 2**30:.1f} GiB free of "
            f"{du.total / 2**30:.1f} GiB; depth cut to {REFERENCE_LAYERS} LLM "
            f"layers (Qwen2-7B widths) so the phase stays in the run's limit")
        t = time.perf_counter()
        model_path, llm_path = write_reference_checkpoint(tmp, cfg, seed=11)
        gc.collect()
        torch.cuda.empty_cache()
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
        log(f"[reference] wrote {size / 1e9:.3f} GB in "
            f"{time.perf_counter() - t:.2f} s (model.safetensors "
            f"{os.path.getsize(os.path.join(llm_path, 'model.safetensors')) / 1e9:.3f} GB, bf16)")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t = time.perf_counter()
        rcfg, params, tts, tok = build_system_from_reference(
            model_path, llm_path, quantize_llm_bits=8, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        llm = rcfg.audio_llm.llm
        shape = lambda c: (c.num_layers, c.vocab_size, c.hidden,  # noqa: E731
                           c.num_heads, c.num_kv_heads, c.ffn)
        if shape(llm) != shape(cfg.audio_llm.llm):
            raise AssertionError(f"the loaded LLM config {shape(llm)} is not "
                                 f"the HF config.json's {shape(cfg.audio_llm.llm)}")
        wq = params["llm"]["layers"]["q"]["w_q"]
        if wq.dtype != torch.int8 or wq.device.type != "cuda" \
                or not wq.is_contiguous():
            raise AssertionError(f"the loaded q projection is {wq.dtype} on "
                                 f"{wq.device}")
        log(f"[reference] ({smi}) build_system_from_reference(quantize_llm_bits"
            f"=8) in {load_s:.2f} s (host read + convert + int8 quantization + "
            f"copy to the card); LLM config from the HF config.json: "
            f"{REFERENCE_LAYERS} layers, vocab {llm.vocab_size}, hidden "
            f"{llm.hidden}, heads {llm.num_heads}/{llm.num_kv_heads}, ffn "
            f"{llm.ffn}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        pipeline = InferencePipeline(rcfg, params=params, tokenizer=tok,
                                     device="cuda")
        args = argparse.Namespace(
            input_wav=os.path.join(root, TINY_DATA, "dev_wavs", "qa_000.wav"),
            output_wav=os.path.join(tmp, "out.wav"), max_tokens=16, seed=0,
            model_path=None, voice_wav=None, device="cuda")
        reset_spans()
        t = time.perf_counter()
        text, pcm = offline_infer.run_inference(rcfg, args, pipeline=pipeline,
                                                tts_params=tts)
        infer_s = time.perf_counter() - t
        infer_launches = read_launches()
        log(f"[reference] ({smi}) run_inference one turn in {infer_s:.2f} s: text "
            f"{text!r} (random weights: ids >= 256 decode to nothing), "
            f"{pcm.shape[0]} samples; launches {infer_launches}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del pipeline, params, tts
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t = time.perf_counter()
        server = Server(get_args(["--model_path", model_path, "--llm_path",
                                  llm_path]))
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        if server.service is not None or \
                server.cfg.audio_llm.llm.num_layers != REFERENCE_LAYERS or \
                "w_q" not in server.pipeline.core.params["llm"]["layers"]["q"]:
            raise AssertionError("the server did not serve the checkpoint's "
                                 "int8 LLM on the per-session path")
        sink = EventSink()
        session = DuplexSession(server.pipeline, server.cfg, sink=sink, sid="ref")
        session.warmup()
        session.reset_context()
        n = server.cfg.duplex.gating.samples_per_chunk
        speech = 0.5 * speech_surrogate(np.random.RandomState(11), 12 * n)
        updates = []
        for i in range(12):
            session.enqueue_audio_data("user", {"audio": speech[i * n:(i + 1) * n],
                                                "enc": "f32"})
            while session.pump():
                pass
            updates = sink.events_of("dialog_state_update")
            if i >= 1 and len(updates) >= 2:
                break
        torch.cuda.synchronize()
        serve_launches = read_launches()
        probs = [u["probs"] for u in updates]
        log(f"[reference] ({smi}) Server(--model_path, --llm_path) built in "
            f"{serve_s:.2f} s; one DuplexSession: reset, then {i + 1} user chunks "
            f"until 2 dialog_state_update events: {probs}; launches "
            f"{serve_launches}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if len(updates) < 2 or not all(np.isfinite([p["state_1"], p["state_2"]]).all()
                                       for p in probs):
            raise AssertionError(f"the served session answered {probs}")
        if sink.events_of("error"):
            raise AssertionError(f"session errors: {sink.events_of('error')}")
        session.release()
        del server, session
        launches = {k: infer_launches[k] + serve_launches[k] for k in infer_launches}
        log(f"[reference] launches in phase 11c: K1 quant_matmul "
            f"{launches['quant_matmul']}, K4 decode_attention_blocked "
            f"{launches['decode_attention_blocked']}, K2 {launches['prefill_quant']}, "
            f"K3 {launches['decode_attention']}, K5 {launches['quant_matmul4']}")
        if launches["quant_matmul"] == 0 or launches["decode_attention_blocked"] == 0:
            raise AssertionError(f"K1 and K4 must launch in 11c: {launches}")
        return {"load_s": load_s, "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: voice prompts, the LoRA merge, serving snapshots, the codec and
# output-CER CLIs
# ---------------------------------------------------------------------------

LORA_RANK = 16
GST_TIE = 1e-5        # a differing voice token's distance within this of the least
REPLAY_ATOL = 1e-3    # restored ticks against the uninterrupted run
SNAPSHOT_TICKS = 10   # ticks before the snapshot, and again after it
VOICE_WAV = os.path.join(TINY_DATA, "dev_wavs", "asr_000.wav")


def lora_adapter(llm_cfg, seed, device):
    """A rank-LORA_RANK adapter on all 7 targets, its B drawn non-zero (an
    untrained adapter's B is zero): the delta moves each weight by ~5-10 %
    of its range."""
    import torch

    from freeze_omni_tpu_torch.models import lora

    g = torch.Generator(device=device).manual_seed(seed)
    tree = lora.init(llm_cfg, g, rank=LORA_RANK, targets=lora.TARGETS,
                     device=device)
    for pair in tree.values():
        pair["b"] = 0.05 * torch.randn(pair["b"].shape, generator=g, device=device)
    return tree


def merge_agreement(card, cpu):
    """Card against CPU over the merged layer leaves: dense leaves within
    1e-6, scales within one f32 ulp, codes equal where the scales are and
    within one elsewhere. Returns (scale ulps {0: n, 1: n}, codes off by
    one)."""
    import numpy as np
    import torch

    ulps, off = {0: 0, 1: 0}, 0
    for name, leaves in cpu["layers"].items():
        for key, c in leaves.items():
            g = card["layers"][name][key].cpu()
            if g.dtype != c.dtype or g.shape != c.shape:
                raise AssertionError(f"merged {name}.{key}: {g.dtype} {tuple(g.shape)} "
                                     f"vs {c.dtype} {tuple(c.shape)}")
            if key in ("scale", "scale4"):
                u = (g.view(torch.int32).long() - c.view(torch.int32).long()).abs()
                if int(u.max()) > 1:
                    raise AssertionError(f"merged {name}.{key}: scales {int(u.max())} "
                                         f"ulps apart")
                for k in ulps:
                    ulps[k] += int((u == k).sum())
            elif key in ("w_q", "w_q4"):
                sk = "scale" if key == "w_q" else "scale4"
                same = (card["layers"][name][sk].cpu() == leaves[sk]).numpy()
                a, b = g.numpy(), c.numpy()
                if key == "w_q4":
                    rows = same.repeat(a.shape[-2] // same.shape[-2], axis=-2)
                    parts = [(a & 0xF, b & 0xF), (a >> 4, b >> 4)]
                else:
                    rows = np.broadcast_to(same[..., None, :], a.shape)
                    parts = [(a, b)]
                for x, y in parts:
                    d = np.abs(x.astype(np.int16) - y.astype(np.int16))
                    if d.max() > 1 or d[rows].any():
                        raise AssertionError(f"merged {name}.{key}: codes differ "
                                             f"by {d.max()} ({int(d[rows].sum())} "
                                             f"where the scales are equal)")
                    off += int(d.sum())
            else:
                err = float((g.float() - c.float()).abs().max())
                if err > 1e-6:
                    raise AssertionError(f"merged {name}.{key}: |d| {err}")
    return ulps, off


def phase_lora_parity(smi):
    """12a: the LoRA merge card against CPU at full width with 2 LLM layers,
    into int8 and into int4 trees as the flagship server draws them, then
    one tick run on the merged weights, card against CPU (phase 4's rule)."""
    import torch

    from freeze_omni_tpu_torch.models import audio_llm, lora

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parity_config()
    adapter = lora_adapter(cfg.audio_llm.llm, 12, "cuda")
    # the f32 delta A @ B of layer 0, card against CPU
    delta_off = {name: int((lora._delta(p["a"][0], p["b"][0], 1.0).cpu()
                            != lora._delta(p["a"][0].cpu(), p["b"][0].cpu(), 1.0)
                            ).sum()) for name, p in adapter.items()}
    log(f"[lora] ({smi}) f32 delta of layer 0, card vs CPU, elements that "
        f"differ: {delta_off}")
    for bits in (8, 4):
        params = audio_llm.init_params(cfg.audio_llm, seed=1, device="cuda",
                                       quantize_llm=True, quant_bits=bits)
        cpu_params = tree_to(params, "cpu")
        torch.cuda.synchronize()
        t = time.perf_counter()
        params["llm"] = lora.merge(params["llm"], adapter, 1.0)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu_params["llm"] = lora.merge(cpu_params["llm"], tree_to(adapter, "cpu"), 1.0)
        cpu_s = time.perf_counter() - t
        ulps, off = merge_agreement(params["llm"], cpu_params["llm"])
        log(f"[lora] ({smi}) int{bits}, 2 layers x 7 targets at Qwen2-7B widths, "
            f"rank {LORA_RANK}: merge {card_s:.3f} s on the card, {cpu_s:.3f} s on "
            f"the CPU; scales equal {ulps[0]}, 1 ulp apart {ulps[1]}; codes off "
            f"by one {off}")
        tick_parity(cfg, params, cpu_params, 4, f"int{bits} weights + LoRA merged")
        del params, cpu_params
    torch.backends.cudnn.allow_tf32 = True   # serving default


def gst_distances(codec_params, ccfg, wav, sr):
    """Per group, the distance of every global-style-token codeword to the
    voice's global feature (codec._nearest's), from the features
    extract_global_tokens computes, on the params' device."""
    import torch

    from freeze_omni_tpu_torch.models import codec
    from freeze_omni_tpu_torch.tts import codec_input

    x = codec_input(ccfg, wav, sr)
    dev = codec_params["encoder"]["conv_pre"]["w"].device
    with torch.no_grad():
        _, gfeat = codec.encode_features(codec_params, ccfg,
                                         torch.from_numpy(x[None, None]).to(dev))
    w = ccfg.global_feature_dim // ccfg.global_code_num
    return [codec.codeword_distances(codec_params["quantizer"]["gst"][g],
                                     gfeat[:, g * w:(g + 1) * w])[0].cpu()
            for g in range(ccfg.global_code_num)]


def phase_snapshot_server(smi):
    """12b: Server(SERVE_ARGV + --lora, --voice_wav, --state_dir) at full
    depth, its ticker stopped and its engine driven here: 8 sessions tick,
    snapshot through Server.snapshot, tick on (recorded); a second server
    with the same flags restores through Server.restore_snapshot, its
    clients reattach and the recorded ticks are replayed; then one step at
    threshold 0 makes the sessions inside an IPU speak in the voice."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.bin import serve
    from freeze_omni_tpu_torch.frontend.wav import read_wav
    from freeze_omni_tpu_torch.models import lora
    from freeze_omni_tpu_torch.runtime.tts_batch import BatchedTTS
    from freeze_omni_tpu_torch.tts import extract_global_tokens

    root = os.path.dirname(os.path.abspath(__file__))
    voice = os.path.join(root, VOICE_WAV)
    tmp = tempfile.mkdtemp(prefix="phase12_")
    merge_s = []
    merge = serve._merge_lora

    def timed_merge(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = merge(*a, **k)
        torch.cuda.synchronize()
        merge_s.append(time.perf_counter() - t)
        return out

    try:
        cfg = serve.flagship_system()
        adapter = os.path.join(tmp, "adapter.npz")
        lora.save(adapter, lora_adapter(cfg.audio_llm.llm, 13, "cpu"), 1.0)
        state = os.path.join(tmp, "state")
        argv = SERVE_ARGV + ["--lora", adapter, "--voice_wav", voice,
                             "--state_dir", state]

        def boot():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            serve._merge_lora = timed_merge
            # the voice prompt's f32 encoder without TF32, as on the CPU
            torch.backends.cudnn.allow_tf32 = False
            t = time.perf_counter()
            try:
                server = serve.Server(serve.get_args(argv))
            finally:
                torch.backends.cudnn.allow_tf32 = True
                serve._merge_lora = merge
            server.stop_ticker()
            torch.cuda.synchronize()
            log(f"[snapshot] ({smi}) Server({' '.join(argv[len(SERVE_ARGV):])} "
                f"+ phase 9's flags) built in {time.perf_counter() - t:.1f} s; "
                f"LoRA merge over {cfg.audio_llm.llm.num_layers} layers x 7 "
                f"targets into the int4 tree {merge_s[-1]:.2f} s; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            return server

        server = boot()
        svc, engine = server.service, server.service.engine
        llm = engine.core.params["llm"]
        if any("w_q4" not in llm["layers"][n] for n in lora.TARGETS):
            raise AssertionError("the merged server's projections are not int4")
        card_gst = tuple(server.cfg.tts.codec.global_tokens)
        codec_cpu = tree_to(svc.tts_params["codec"], "cpu")
        wav, sr = read_wav(voice)
        t = time.perf_counter()
        cpu_gst = extract_global_tokens(codec_cpu, cfg.tts.codec, wav, sr)
        cpu_s = time.perf_counter() - t
        ties = []
        dist = (gst_distances(codec_cpu, cfg.tts.codec, wav, sr)
                if card_gst != tuple(cpu_gst) else None)
        for g, (a, b) in enumerate(zip(card_gst, cpu_gst)):
            if a != b:
                gap = float(dist[g][a] - dist[g][b]) / abs(float(dist[g][b]))
                ties.append((g, a, b, gap))
                if gap > GST_TIE:
                    raise AssertionError(f"voice token {g}: card {a}, cpu {b}, "
                                         f"distance {gap:.3e} relative apart")
        log(f"[snapshot] voice tokens of {VOICE_WAV}: card {list(card_gst)}, cpu "
            f"{list(cpu_gst)} ({cpu_s:.2f} s on the CPU); near-ties {ties}")
        default_gst = tuple(cfg.tts.codec.global_tokens)
        if card_gst == default_gst:
            raise AssertionError("the voice tokens are the default ones")

        sids = [f"r{i}" for i in range(8)]
        sinks = {sid: svc.open_session(sid) for sid in sids}
        feeds = session_feeds(cfg.duplex.gating, len(sids), 2 * SNAPSHOT_TICKS)
        plan = [[(sid, ident, item) for sid, feed in zip(sids, feeds)
                 for ident in ("user", "system")
                 for item in [feed[ident].next(t)] if item is not None]
                for t in range(2 * SNAPSHOT_TICKS)]

        def run_ticks(eng, ticks):
            out = []
            for t in ticks:
                for sid, ident, item in plan[t]:
                    eng.submit_chunk(sid, ident, *item)
                res = eng.tick().get("user", {})
                slots = {sid: eng.store.slot_of(sid) for sid in sids}
                out.append(({sid: res[s] for sid, s in slots.items() if s in res},
                            {sid: eng.store.kv_length(s) for sid, s in slots.items()}))
            return out

        zero_launches()
        run_ticks(engine, range(SNAPSHOT_TICKS))
        at_snapshot = {sid: engine.store.kv_length(engine.store.slot_of(sid))
                       for sid in sids}
        torch.cuda.synchronize()
        t = time.perf_counter()
        saved = server.snapshot()
        snap_s = time.perf_counter() - t
        size = sum(os.path.getsize(os.path.join(state, f)) for f in os.listdir(state))
        if sorted(saved) != sorted(sids):
            raise AssertionError(f"snapshot saved {saved}")
        recorded = run_ticks(engine, range(SNAPSHOT_TICKS, 2 * SNAPSHOT_TICKS))
        del server, svc, engine, llm, sinks
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[snapshot] ({smi}) {SNAPSHOT_TICKS} dual ticks x 8 sessions, then "
            f"Server.snapshot: {len(saved)} sessions, {size / 1e6:.1f} MB written "
            f"in {snap_s:.2f} s (KV lengths {list(at_snapshot.values())}); "
            f"{SNAPSHOT_TICKS} more ticks recorded; the server freed")

        server = boot()
        svc, engine = server.service, server.service.engine
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored = server.restore_snapshot()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        sinks = {sid: svc.open_session(sid) for sid in sids}   # clients reattach
        reattached = {sid: engine.store.kv_length(engine.store.slot_of(sid))
                      for sid in sids}
        if sorted(restored) != sorted(sids) or reattached != at_snapshot:
            raise AssertionError(f"restored {restored}, KV lengths {reattached} "
                                 f"vs {at_snapshot}")
        before = read_launches()
        replayed = run_ticks(engine, range(SNAPSHOT_TICKS, 2 * SNAPSHOT_TICKS))
        tick_launches = {k: v - before[k] for k, v in read_launches().items()}
        thr, worst, compared, exempt = cfg.duplex.resp_threshold, 0.0, 0, 0
        for t, ((rp, rl), (pp, pl)) in enumerate(zip(recorded, replayed)):
            if rl != pl or sorted(rp) != sorted(pp):
                raise AssertionError(f"replayed tick {t}: KV lengths {pl} vs {rl}, "
                                     f"predicted {sorted(pp)} vs {sorted(rp)}")
            for sid in rp:
                for key in ("state_1", "state_2"):
                    a, b = pp[sid][key], rp[sid][key]
                    worst = max(worst, abs(a - b))
                    compared += 1
                    if not (np.isfinite(a) and abs(a - b) <= REPLAY_ATOL):
                        raise AssertionError(f"replayed tick {t} {sid} {key}: "
                                             f"{a} vs recorded {b}")
                    if (a > thr) != (b > thr):
                        if abs(b - thr) > REPLAY_ATOL:
                            raise AssertionError(f"replayed tick {t} {sid}: "
                                                 f"decision differs")
                        exempt += 1
        if not compared:
            raise AssertionError("no replayed prediction was compared")
        log(f"[snapshot] ({smi}) the second server restored {len(restored)} "
            f"sessions in {restore_s:.2f} s (read, requantized to int8 KV); "
            f"reattached with their KV lengths; {SNAPSHOT_TICKS} replayed ticks "
            f"against the recorded run: max |dprob| {worst:.3e} over {compared} "
            f"probabilities (atol {REPLAY_ATOL}), KV lengths and decisions equal "
            f"({exempt} within atol of the threshold); launches {tick_launches}")
        for key in ("quant_matmul4", "prefill_quant"):
            if not tick_launches[key]:
                raise AssertionError(f"{key} did not launch on the restored ticks")

        # the sessions inside an IPU speak, in the voice
        svc.resp_threshold = 2.0
        n = cfg.duplex.gating.samples_per_chunk
        users = user_streams(len(sids), n)
        rng = np.random.RandomState(12)
        for k in range(60):
            in_ipu = sum(svc.sessions[sid].vad["user"].in_speech for sid in sids)
            fire = in_ipu >= len(sids) // 2 or (in_ipu and k >= 30)
            for i, sid in enumerate(sids):
                svc.enqueue_audio_data(sid, "user", {"audio": users[i][k * n:(k + 1) * n]})
                svc.enqueue_audio_data(sid, "system", {
                    "audio": (LINE_NOISE * rng.randn(n)).astype(np.float32)})
            if fire:
                svc.resp_threshold = 0.0
                before = read_launches()
            svc.step()
            if fire:
                break
        else:
            raise AssertionError("no user IPU opened in 60 steps")
        torch.cuda.synchronize()
        resp_launches = {k: v - before[k] for k, v in read_launches().items()}
        speakers = {sid: sinks[sid].events_of("response_audio") for sid in sids}
        speakers = {sid: ev for sid, ev in speakers.items() if ev}
        if not speakers:
            raise AssertionError("the threshold-0 step made no session speak")
        for sid, ev in speakers.items():
            for a in ev:
                if not (np.isfinite(a["pcm"]).all() and np.abs(a["pcm"]).max() <= 1):
                    raise AssertionError(f"{sid}: voice PCM not finite or outside [-1, 1]")
        if not resp_launches["quant_matmul"] or not resp_launches["decode_attention_blocked"]:
            raise AssertionError(f"K1 and K4 must launch in the response: {resp_launches}")

        # one fixed sentence, greedy, in the voice and in the default voice:
        # the same codec tokens, so the PCM differs only by the style tokens
        tcfg = dataclasses.replace(server.cfg.tts, top_k=1, max_tokens=120)
        text = fixed_sentences()[0]
        hidden, prefix = sentence_inputs(engine, text, [np.asarray(
            engine.embed_tokens([65, 66, 67]))[None]])
        pcm = {}
        for name, tokens in (("voice", card_gst), ("again", card_gst),
                             ("default", default_gst)):
            pool = BatchedTTS(svc.tts_params, tcfg, capacity=1, device="cuda")
            pool.set_global_tokens(tokens)
            pcm[name] = _pool_sentence(pool, name, hidden, prefix)

        def dpcm(a, b):
            return float(np.abs(pcm[a] - pcm[b]).max()) \
                if pcm[a].shape == pcm[b].shape else float("inf")

        # the voice against the same call repeated (the floor) and against
        # the default tokens
        d, floor = dpcm("voice", "default"), dpcm("voice", "again")
        if not (np.isfinite(pcm["voice"]).all() and d > max(10 * floor, 1e-6)):
            raise AssertionError(f"the voice's PCM does not differ from the "
                                 f"default voice's: max |d| {d}, repeat {floor}")
        launches = read_launches()
        log(f"[snapshot] ({smi}) threshold-0 step: {len(speakers)} sessions spoke "
            f"({', '.join(speakers)}), PCM finite within [-1, 1]; launches in "
            f"the step {resp_launches}; {text!r} in the voice vs the default "
            f"tokens (greedy, same codec tokens): max |dpcm| {d:.3e}, the same "
            f"call repeated {floor:.3e}; launches in "
            f"12b {launches}")
        del server, svc, engine, sinks
        gc.collect()
        torch.cuda.empty_cache()
        return {"launches": launches, "merge_s": merge_s, "snapshot_s": snap_s,
                "snapshot_bytes": size, "restore_s": restore_s, "dprob": worst}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_codec_tool(smi):
    """12c: bin/codec_tool.main on a dev wav at the flagship codec (seeded
    random weights with the encoder branch) on the card."""
    import tempfile

    import numpy as np

    from freeze_omni_tpu_torch.bin import codec_tool

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="codec_") as tmp:
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            codes, gst, recon = codec_tool.main([
                "--preset", "flagship", "--input_wav", os.path.join(root, VOICE_WAV),
                "--output_wav", os.path.join(tmp, "out.wav"), "--device", "cuda"])
        seconds = time.perf_counter() - t
    if not (np.isfinite(recon).all() and recon.size):
        raise AssertionError("codec_tool's reconstruction is empty or not finite")
    log(f"[codec] ({smi}) codec_tool at the flagship codec: codes {codes.shape}, "
        f"global tokens {gst.ravel().tolist()}, {recon.size} samples, finite, "
        f"in {seconds:.2f} s wall")


def phase_out_cer(smi):
    """12d: bin/out_cer_eval.main on the trained tiny system (the port's
    copy) at top-k 1 on sentences.txt, on the card and on the CPU, TF32
    off."""
    import torch

    from freeze_omni_tpu_torch.bin import out_cer_eval

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TINY_DATA, "QUALITY.json")) as f:
        quality = json.load(f)["out_cer_by_top_k"]["1"]
    flags = ["--model_path", os.path.join(root, TINY_COPY), "--manifest",
             os.path.join(root, TINY_DATA, "sentences.txt"), "--top_k", "1",
             "--max_tokens", "24"]
    before = read_launches()
    card, card_s = _harness(out_cer_eval.main, flags + ["--device", "cuda"])
    launches = {k: v - before[k] for k, v in read_launches().items()}
    t = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        cpu = out_cer_eval.main(flags + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t
    with open(os.path.join(root, TINY_DATA, "sentences.txt")) as f:
        refs = [ln.strip() for ln in f if ln.strip()]
    hyps = (card["hypotheses"][1], cpu["hypotheses"][1])
    differ = [(r, a, b) for r, a, b in zip(refs, *hyps) if a != b]
    log(f"[out-cer] ({smi}) the trained tiny system, top-k 1, {len(refs)} "
        f"sentences, TF32 off: out-CER card {card['by_top_k'][1]:.2f} % "
        f"({card_s:.2f} s wall), cpu {cpu['by_top_k'][1]:.2f} % ({cpu_s:.2f} s), "
        f"QUALITY.json {quality:.2f} %; {len(differ)} hypotheses differ"
        + "".join(f"; {r!r}: card {a!r}, cpu {b!r}" for r, a, b in differ)
        + f"; launches {launches}")
    if launches["decode_attention_blocked"] == 0:
        raise AssertionError("out_cer_eval's StreamingTTS launched no K4")
    torch.backends.cudnn.allow_tf32 = True   # serving default
    return launches


# ---------------------------------------------------------------------------
# phase 13: the native host frontend
# ---------------------------------------------------------------------------

NATIVE_FBANK_TOL = dict(rtol=1e-4, atol=1e-3)   # tests/test_native.py's
NATIVE_RESAMPLE_ATOL = 1e-6
NATIVE_VAD_TOL = 2e-3
FRONT_STEPS = 100            # 224 ms steps of the frontend A/B


def frontend_streams(n_sessions, n, steps):
    """Per session and identity, `steps` chunks of n samples: the users
    speak (user_streams), the system line is LINE_NOISE noise."""
    import numpy as np

    users = user_streams(n_sessions, n)
    rng = np.random.RandomState(1)
    out = []
    for s in range(n_sessions):
        u = np.concatenate([users[s], np.zeros(steps * n, np.float32)])[:steps * n]
        sysline = (LINE_NOISE * rng.randn(steps * n)).astype(np.float32)
        out += [u.reshape(steps, n), sysline.reshape(steps, n)]
    return out


def frontend_step_times(cfg, streams, native_on):
    """ms per 224 ms step of every stream's VAD + fbank gating (the
    duplex.engine.vad_stage work the native core replaces), with the native
    core or with the numpy/torch paths."""
    import dataclasses

    import numpy as np

    from freeze_omni_tpu_torch.duplex.vad import make_vad
    from freeze_omni_tpu_torch.frontend.chunker import GatingChunker

    gcfg = cfg.duplex.gating
    vad_cfg = dataclasses.replace(cfg.duplex.vad, chunk_size=gcfg.samples_per_chunk)
    vads = [make_vad(vad_cfg, identity=("user", "system")[j % 2])
            for j in range(len(streams))]
    gates = [GatingChunker(gcfg) for _ in streams]
    if not native_on:
        for obj in vads + gates:
            obj._native = None
    if (vads[0]._native is not None) != native_on or \
            (gates[0]._native is not None) != native_on:
        raise AssertionError(f"frontend path is not the {native_on=} one")
    times, statuses = [], []
    for k in range(streams[0].shape[0]):
        t = time.perf_counter()
        for v, g, s in zip(vads, gates, streams):
            ann = v.predict({"audio": s[k], "time_stamp": 0.0})
            g.process_and_gate({"audio": ann["audio"], "status": ann["status"]})
            statuses.append(ann["status"])
        times.append((time.perf_counter() - t) * 1e3)
    return np.array(times), statuses


def phase_native_frontend(smi, service_front):
    """13: the native host frontend (frontend/native.py over native/frontend/
    *.cc, built with g++ on this host): the port's chunkers, resamplers and
    learned VAD must take it, held to their numpy/torch paths; then the
    frontend work of phase 9's step (8 sessions, both identities: VAD +
    fbank gating a 224 ms chunk) timed with the native core and with the
    numpy/torch paths, in turns (numpy, native, native, numpy)."""
    import numpy as np

    from freeze_omni_tpu_torch.config import FbankConfig, flagship_system
    from freeze_omni_tpu_torch.duplex.vad import LearnedVAD
    from freeze_omni_tpu_torch.frontend import native, wav
    from freeze_omni_tpu_torch.frontend.chunker import GatingChunker, OfflineChunker
    from freeze_omni_tpu_torch.frontend.fbank import fbank_ref

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native frontend did not build on this host")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    log(f"[native] {gxx.stdout.splitlines()[0]}; library "
        f"{native.library_path().name} ({time.perf_counter() - t0:.2f} s to build "
        f"and load)")
    cfg = flagship_system()
    gcfg = cfg.duplex.gating
    n = gcfg.samples_per_chunk
    rng = np.random.RandomState(7)
    errs = {}

    def held(name, got, ref, **tol):
        np.testing.assert_allclose(got, ref, **tol, err_msg=name)
        errs[name] = float(np.abs(np.asarray(got) - np.asarray(ref)).max(initial=0.0))

    x = (rng.randn(4000) * 1500).astype(np.float32)
    held("fbank 25/10", native.NativeFbank()(x), fbank_ref(x, FbankConfig()),
         **NATIVE_FBANK_TOL)
    held("fbank 16/8", native.NativeFbank(frame_ms=16, shift_ms=8)(x),
         fbank_ref(x, gcfg.fbank()), **NATIVE_FBANK_TOL)
    for name, cls, size, fn in (("offline chunker", OfflineChunker, 2560, "process"),
                                ("gating chunker", GatingChunker, n, "extract")):
        nat, py = cls(), cls()
        if nat._native is None:
            raise AssertionError(f"{name} did not take the native core")
        py._native = None
        for _ in range(6):
            a = (rng.randn(size) * 0.05).astype(np.float32)
            held(name, getattr(nat, fn)(a), getattr(py, fn)(a), **NATIVE_FBANK_TOL)
    speech = 0.5 * speech_surrogate(np.random.RandomState(3), 48000, sr=48000)
    held("resample 48k->16k", wav.resample(speech, 48000, 16000),
         wav.resample_numpy(speech, 48000, 16000), rtol=0, atol=NATIVE_RESAMPLE_ATOL)
    rs = wav.StreamingResampler(48000, 16000)
    if rs._native is None:
        raise AssertionError("StreamingResampler did not take the native core")
    parts = [rs.push(speech[i:i + 1920]) for i in range(0, len(speech), 1920)]
    held("streaming resample", np.concatenate(parts + [rs.flush()]),
         wav.resample_numpy(speech, 48000, 16000), rtol=0, atol=NATIVE_RESAMPLE_ATOL)
    nat, py = LearnedVAD(), LearnedVAD()
    if nat._native is None:
        raise AssertionError("LearnedVAD did not take the native core")
    py._native = None
    stream = frontend_streams(1, 512, 240)[0]
    a = [nat.predict({"audio": c, "time_stamp": 0.0}) for c in stream]
    b = [py.predict({"audio": c, "time_stamp": 0.0}) for c in stream]
    held("learned VAD prob", [r["prob"] for r in a], [r["prob"] for r in b],
         rtol=0, atol=NATIVE_VAD_TOL)
    if [r["status"] for r in a] != [r["status"] for r in b]:
        raise AssertionError("native and numpy VAD statuses differ")
    log(f"[native] held to the numpy/torch paths, max |diff|: "
        f"{ {k: round(v, 8) for k, v in errs.items()} }")

    streams = frontend_streams(8, n, FRONT_STEPS)
    runs = {}
    for native_on in (False, True, True, False):
        t, st = frontend_step_times(cfg, streams, native_on)
        runs.setdefault(native_on, []).append(t)
        if not any(s == "ipu_sl" for s in st):
            raise AssertionError("no user IPU opened in the frontend A/B")
    for native_on, label in ((False, "numpy/torch"), (True, "native")):
        for i, t in enumerate(runs[native_on]):
            log(f"[native] ({smi}) frontend step, 8 sessions x 2 identities "
                f"(VAD + gating), {label} run {i + 1}: {pct(t)}")
    p50 = {k: [float(np.percentile(t, 50)) for t in v] for k, v in runs.items()}
    log(f"[native] ({smi}) phase 9's service-step host frontend (VAD + gating + "
        f"serializer) with the native core: {pct(service_front)}; the same "
        f"work's numpy/torch path is timed above (p50 {p50[False]} ms against "
        f"native {p50[True]} ms)")
    log(f"[phase 13] {time.perf_counter() - t0:.1f} s wall")


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

TRAIN_PARITY_STAGES = ("state", "align", "lora", "all")
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_FRAC = 1e-3
TRAIN_PARAM_ATOL = 1e-5
TRAIN_LR = 1e-3
RESUME_RTOL = 1e-5


def worst_grad_err(grads, ref):
    """Worst |grad - ref| over a leaf's largest |ref|, over the leaves whose
    largest entry is above 1e-8 of the tree's (the rest is rounding noise of
    an exactly-zero gradient)."""
    floor = 1e-8 * max(float(r.abs().max()) for r in ref if r.numel())
    return max(float((g.detach().cpu() - r).abs().max()) / float(r.abs().max())
               for g, r in zip(grads, ref) if r.numel() and float(r.abs().max()) > floor)


def params_after_step_agree(card, cpu, grads_cpu):
    """Max |diff| over entries whose CPU gradient is resolved (above 1e-3 of
    the tree's largest gradient) and over all entries: the first Adam step
    moves an entry by about lr * sign(g), so a gradient that is rounding
    noise moves it by up to lr either way on either device."""
    from freeze_omni_tpu_torch.training import optim

    g_all = [g.abs() for g in optim.leaves(grads_cpu)]
    resolved = 1e-3 * max(float(g.max()) for g in g_all if g.numel())
    worst_resolved = worst = 0.0
    for a, b, g in zip(optim.leaves(card), optim.leaves(cpu), g_all):
        err = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        sel = err[g > resolved]
        if sel.numel():
            worst_resolved = max(worst_resolved, float(sel.max()))
    return worst_resolved, worst


def phase_train_parity(smi):
    """14a: one stage_step of state, align, lora and all at Qwen2-7B width
    with 2 LLM layers, TF32 off, on the card and on the CPU from the same
    weights (drawn once on the CPU and copied) and the same data.py batch."""
    import torch

    from freeze_omni_tpu_torch.bin.train import stage_trees
    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.models import lora as lora_mod
    from freeze_omni_tpu_torch.models import speech_decoder as sd
    from freeze_omni_tpu_torch.training import data as data_mod
    from freeze_omni_tpu_torch.training import optim
    from freeze_omni_tpu_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = parity_config()
    acfg, dcfg = cfg.audio_llm, cfg.tts.decoder
    t = time.perf_counter()
    params = audio_llm.init_params(acfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    dec = sd.init_params(dcfg, gen, device="cpu")
    lo = lora_mod.init(acfg.llm, gen, rank=8, device="cpu")
    for pair in lo.values():   # B drawn non-zero, so A's gradient is not 0
        pair["b"].normal_(0.0, 0.02, generator=gen)
    llm_card = tree_to(params["llm"], "cuda")
    log(f"[train] 2-layer Qwen2-7B-width trees drawn and copied in "
        f"{time.perf_counter() - t:.1f} s")
    for stage in TRAIN_PARITY_STAGES:
        trainable, frozen = stage_trees(
            stage, params, {"lora": lo}.get(stage, dec))
        batch = next(data_mod.stage_batches(stage, acfg, dcfg, 2, 1, seed=11))
        out = {}
        for dev in ("cuda", "cpu"):
            fr = {"llm": llm_card} if dev == "cuda" else frozen
            state = ts.init_train_state(tree_to(trainable, dev), lr=TRAIN_LR)
            t = time.perf_counter()
            state, m = ts.stage_step(stage, state, fr, acfg, dcfg,
                                     ts.to_tensors(batch, dev))
            loss = float(m["loss"])
            out[dev] = (loss, state, time.perf_counter() - t)
        (lc, sc, tc), (lh, sh, th) = out["cuda"], out["cpu"]
        rel = abs(lc - lh) / abs(lh)
        g_cpu = optim.leaves(optim.map_tree(lambda p: p.grad, sh.trainable))
        # a leaf whose gradient is exactly 0 in exact arithmetic (the
        # encoder's key bias, under a softmax that ignores it) holds rounding
        # noise (~1e-11) on both devices: the floor is 1e-8 of the tree's
        # largest gradient, under 1e-3 of any other leaf's largest entry
        floor = 1e-8 * max(float(g.abs().max()) for g in g_cpu if g.numel())
        g_err, zero_leaves = 0.0, 0
        for gc_, gh in zip(optim.leaves(optim.map_tree(lambda p: p.grad, sc.trainable)),
                           g_cpu):
            scale = float(gh.abs().max()) if gh.numel() else 0.0
            e = float((gc_.cpu() - gh).abs().max()) if gh.numel() else 0.0
            if e > TRAIN_GRAD_FRAC * scale + floor:
                raise AssertionError(f"{stage}: a gradient differs card vs CPU by "
                                     f"{e} (largest entry {scale})")
            if scale > floor:
                g_err = max(g_err, e / scale)
            else:
                zero_leaves += 1
        worst_res, worst = params_after_step_agree(
            sc.trainable, sh.trainable, optim.map_tree(lambda p: p.grad, sh.trainable))
        log(f"[train] ({smi}) {stage}: loss card {lc:.6f} CPU {lh:.6f} (rel "
            f"{rel:.2e}); gradients within {g_err:.2e} of each leaf's largest "
            f"({zero_leaves} leaves of rounding noise under the floor {floor:.1e}); "
            f"params after the step within {worst_res:.2e} where the gradient "
            f"is resolved, {worst:.2e} anywhere; step {tc:.3f} s card, {th:.3f} s CPU")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"{stage}: loss card {lc} vs CPU {lh}")
        if not (worst_res <= TRAIN_PARAM_ATOL and worst <= 2 * TRAIN_LR):
            raise AssertionError(f"{stage}: params after the step differ by "
                                 f"{worst_res} (resolved) / {worst}")
        if stage == "state":
            # why stage_step turns cuDNN off: the same gradients with it on
            tr = optim.trainable(tree_to(trainable, "cuda"))
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                loss = ts.stage_loss(stage, tr, {"llm": llm_card}, acfg, dcfg,
                                     ts.to_tensors(batch, "cuda"))
                g = torch.autograd.grad(loss, optim.leaves(tr), allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(optim.leaves(tr), g)]
            ref = optim.leaves(optim.map_tree(lambda p: p.grad, sh.trainable))
            log(f"[train] ({smi}) state with cuDNN on (TF32 off): gradients within "
                f"{worst_grad_err(g, ref):.2e} of each leaf's largest (stage_step, "
                f"cuDNN off: {g_err:.2e})")
            del tr, g
        del out, sc, sh
    del params, llm_card
    torch.backends.cudnn.allow_tf32 = True   # serving default


def train_run(argv):
    """bin/train.run on the card, in this process (run() starts none);
    returns its output with the peak device memory."""
    import torch

    from freeze_omni_tpu_torch.bin import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = train.run(train.get_args(argv))
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase_train_flagship(smi):
    """14b/c: bin/train.py at full width and depth on the card: --stage state
    for 6 steps (checkpoint every 3), then 3 steps and --resume for 3 more,
    the resumed losses equal to the uninterrupted ones; then a short --stage
    lora run whose lora.npz serve --lora (`bin/serve._merge_lora`) merges
    into an int4 Qwen2-7B tree as the --quant 4 server draws it."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.bin.serve import _merge_lora
    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models import lora as lora_mod
    from freeze_omni_tpu_torch.ops.quant import (dequantize_weight_int4,
                                                 init_quantized_llm)

    base = ["--preset", "flagship", "--stage", "state", "--batch", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        full = train_run(base + ["--steps", "6", "--save_every", "3",
                                 "--ckpt_dir", os.path.join(tmp, "a")])
        t_full = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        ck = os.path.join(tmp, "b")
        first = train_run(base + ["--steps", "3", "--save_every", "3",
                                  "--ckpt_dir", ck])
        gc.collect()
        torch.cuda.empty_cache()
        rest = train_run(base + ["--steps", "3", "--save_every", "3",
                                 "--ckpt_dir", ck, "--resume"])
        gc.collect()
        torch.cuda.empty_cache()
        rel = np.abs(np.array(rest["losses"]) - np.array(full["losses"][3:])) \
            / np.abs(np.array(full["losses"][3:]))
        s_step = np.array(full["step_seconds"][1:])
        log(f"[train] ({smi}) bin/train.py --preset flagship --stage state "
            f"--steps 6 --batch 2: {t_full:.1f} s in all (the f32 LLM drawn on "
            f"the card included); s/step {np.median(s_step):.4f} median, "
            f"{s_step.min():.4f}-{s_step.max():.4f} (steps 2-6), first step "
            f"{full['step_seconds'][0]:.3f} s; peak {full['peak_gib']:.2f} GiB; "
            f"loss {full['losses'][0]:.6f} -> {full['losses'][-1]:.6f}")
        log(f"[train] ({smi}) resume: steps 1-3 {first['losses']}, resumed "
            f"steps 4-6 {rest['losses']} against the uninterrupted "
            f"{full['losses'][3:]}: max rel {rel.max():.2e}; peak "
            f"{rest['peak_gib']:.2f} GiB")
        if rest["final_step"] != 6 or not rel.max() <= RESUME_RTOL:
            raise AssertionError("the resumed run does not continue the "
                                 "uninterrupted one")
        if not np.isfinite(full["losses"]).all():
            raise AssertionError("non-finite training loss")

        lo_dir = os.path.join(tmp, "lora")
        lo_run = train_run(["--preset", "flagship", "--stage", "lora", "--batch",
                            "2", "--steps", "3", "--lora_rank", "8",
                            "--lora_targets", "q,v", "--lr", "1e-2",
                            "--ckpt_dir", lo_dir])
        gc.collect()
        torch.cuda.empty_cache()
        path = os.path.join(lo_dir, "lora.npz")
        tree, _ = lora_mod.load(path)
        if not all(np.abs(p["b"]).max() > 0 for p in tree.values()):
            raise AssertionError("the trained adapter's B is still zero")
        cfg = flagship_system().audio_llm.llm
        t = time.perf_counter()
        llm = init_quantized_llm(cfg, torch.Generator(device="cuda").manual_seed(0),
                                 "cuda", bits=4)
        layer0 = lambda p: dequantize_weight_int4(  # noqa: E731
            {"w_q4": p["w_q4"][0], "scale4": p["scale4"][0]}, torch.float32)
        before = {n: layer0(llm["layers"][n]) for n in tree}
        llm, scale = _merge_lora(llm, path)
        torch.cuda.synchronize()
        # layer 0's change of weight regressed on the adapter's delta: int4
        # rounding is unbiased against it, so the slope is ~1 where the
        # merge added the delta (0 where it added nothing)
        slope = {}
        for n, pair in tree.items():
            d = (torch.as_tensor(pair["a"][0]).cuda().float()
                 @ torch.as_tensor(pair["b"][0]).cuda().float()) * scale
            dw = layer0(llm["layers"][n]) - before[n]
            slope[n] = float((dw * d).sum() / (d * d).sum())
        log(f"[train] ({smi}) --stage lora (rank 8, q,v, lr 1e-2) 3 steps: loss "
            f"{lo_run['losses']}, peak {lo_run['peak_gib']:.2f} GiB; serve --lora "
            f"merged its lora.npz (scale {scale}) into the int4 tree "
            f"({time.perf_counter() - t:.1f} s with the draw); layer 0's weight "
            f"change against the delta, slope {slope}")
        if not all(0.7 <= v <= 1.3 for v in slope.values()):
            raise AssertionError("the merged int4 weights do not carry the adapter")
        del llm, before


def gan_grads(state, ccfg, wav, gst, dev, flags):
    """The discriminator and generator gradients of gan_step's two losses
    at `state` (one evaluation, no update) on `dev` under the cuDNN
    `flags`, and the seconds."""
    import torch

    from freeze_omni_tpu_torch.training import codec_gan as gan
    from freeze_omni_tpu_torch.training import optim

    gp = optim.trainable(tree_to(state.gen_params, dev))
    dp = optim.trainable(tree_to(state.disc_params, dev))
    wav, gst = wav.to(dev), gst.to(dev)
    t = time.perf_counter()
    with torch.backends.cudnn.flags(**flags):
        fake, aux = gan.autoencode(gp, ccfg, wav, gst)
        n = min(fake.shape[-1], wav.shape[-1])
        fake, wav = fake[..., :n], wav[..., :n]
        d_loss = gan.discriminator_loss(gan.run_discriminators(dp, wav),
                                        gan.run_discriminators(dp, fake.detach()))
        dg = torch.autograd.grad(d_loss, optim.leaves(dp))
        fo = gan.run_discriminators(dp, fake)
        g_loss = (gan.generator_adv_loss(fo) + aux
                  + gan.feature_matching_loss(gan.run_discriminators(dp, wav), fo)
                  + 45.0 * gan.mel_l1_loss(wav, fake, ccfg.sample_rate))
        gg = torch.autograd.grad(g_loss, optim.leaves(gp), allow_unused=True)
    gg = [torch.zeros_like(p) if g is None else g for p, g in zip(optim.leaves(gp), gg)]
    if dev == "cuda":
        torch.cuda.synchronize()
    return ([g.cpu() for g in dg], [g.cpu() for g in gg],
            time.perf_counter() - t)


def phase_train_codec_vad(smi):
    """14d: gan_step at the flagship codec (encoder branch, autoencode with
    the VQ losses, the 5 + 3 discriminators) and the learned VAD's training,
    a few steps each on the card, with finite losses; the GAN's gradients
    card (cuDNN on and off) against CPU beside them."""
    import numpy as np
    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models import codec
    from freeze_omni_tpu_torch.training import codec_gan as gan
    from freeze_omni_tpu_torch.training import vad as vad_train

    ccfg = flagship_system().tts.codec
    gen = torch.Generator(device="cuda").manual_seed(3)
    gen_params = codec.init_params(ccfg, gen, device="cuda", with_encoder=True)
    disc = gan.init_discriminators(gen, device="cuda")
    state = gan.init_gan_state(gen_params, disc, lr=2e-4)
    del gen_params, disc
    rng = np.random.RandomState(4)
    n = 12000   # 0.5 s at 24 kHz: 20 codec frames
    wav = torch.from_numpy(np.stack([0.5 * speech_surrogate(rng, n, sr=24000)
                                     for _ in range(2)])[:, None]).cuda()
    gst = torch.tensor([[list(ccfg.global_tokens)]], device="cuda")
    gen_fn = lambda gp, w: gan.autoencode(gp, ccfg, w, gst)  # noqa: E731
    # gan_step keeps cuDNN: its gradients with and without it, against the
    # CPU's, and the time of each
    ref = gan_grads(state, ccfg, wav, gst, "cpu", {})
    for label, flags in (("cuDNN, TF32 on (torch's default)",
                          dict(enabled=True, allow_tf32=True)),
                         ("cuDNN, TF32 off", dict(enabled=True, allow_tf32=False)),
                         ("no cuDNN", dict(enabled=False)),
                         ("cuDNN, TF32 on, again", dict(enabled=True, allow_tf32=True))):
        got = gan_grads(state, ccfg, wav, gst, "cuda", flags)
        log(f"[train] ({smi}) codec GAN gradients, card ({label}) against the "
            f"CPU: discriminators within {worst_grad_err(got[0], ref[0]):.2e} of "
            f"each leaf's largest, generator {worst_grad_err(got[1], ref[1]):.2e}; "
            f"{got[2]:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, times = [], []
    for _ in range(3):
        t = time.perf_counter()
        state, m = gan.gan_step(state, ccfg, wav, gen_fn)
        rows.append({k: float(v) for k, v in m.items()})
        times.append(time.perf_counter() - t)
    with torch.no_grad():
        feats, _ = codec.encode_features(state.gen_params, ccfg, wav)
    _, n_dead = gan.reseed_dead_codes(state.gen_params, ccfg, feats,
                                      np.random.RandomState(5))
    log(f"[train] ({smi}) codec gan_step x3 (flagship codec, 2 x 0.5 s): "
        f"s/step {[round(t, 3) for t in times]}; losses {rows}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; dead codes "
        f"reseeded {n_dead} of {ccfg.n_codes}")
    if not all(np.isfinite(list(r.values())).all() for r in rows):
        raise AssertionError("non-finite codec GAN loss")
    del state
    t = time.perf_counter()
    out = vad_train.train(steps=3, batch=8, seed=0, device="cuda")
    log(f"[train] ({smi}) learned VAD train, 3 steps x 8 mixtures: "
        f"{time.perf_counter() - t:.1f} s; losses {out['losses'].tolist()}")
    if not np.isfinite(out["losses"]).all():
        raise AssertionError("non-finite VAD loss")


def phase_training(smi):
    """14: training, (a) card vs CPU, (b)-(c) bin/train.py at full size,
    (d) codec GAN and VAD; no kernel launches (the frozen LLM is f32)."""
    import gc

    import torch

    t0 = time.perf_counter()
    zero_launches()
    phase_train_parity(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_flagship(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_codec_vad(smi)
    launches = read_launches()
    log(f"[train] kernel launches in phase 14 {launches}")
    if any(launches.values()):
        raise AssertionError("training launched a serving kernel")
    log(f"[phase 14] {time.perf_counter() - t0:.1f} s wall")



# ---------------------------------------------------------------------------
# phase 15: multi-GPU serving (parallel/, runtime/multihost_serving.py)
# ---------------------------------------------------------------------------

TP_RANK_FLAG = "--tp-rank"     # python3 chip_smoke.py --tp-rank <job.json>
TP_DEVICE = "cuda"
TP_PARITY_ATOL = 2e-3
TP_PARITY_TICKS = 5
TP_SERVE_STEPS = 200           # a serving run's step limit
TP_RANK_TIMEOUT = 480          # seconds a group of ranks may take
TP_SHARD_WAYS = (2, 4)         # the shard shapes of phase 15d


def tp_layout(ranks):
    """(backend, ranks per card) of `ranks` processes on this host: NCCL
    with a card each where there are enough cards, else gloo with the
    ranks sharing the card (NCCL refuses two ranks on one device)."""
    import torch

    from freeze_omni_tpu_torch.parallel.multihost import choose_backend

    backend = choose_backend(TP_DEVICE, ranks)
    return backend, 1 if backend == "nccl" else -(-ranks // torch.cuda.device_count())


def run_ranks(jobs, label):
    """One process per job (this script with TP_RANK_FLAG), all started
    together and met at a free localhost port. Waits for every rank; if one
    fails or the time runs out, kills the others and raises with each
    rank's log. Returns the ranks' results in job order."""
    import shutil
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    tmp = tempfile.mkdtemp(prefix="tp-ranks-")
    procs = []
    for i, job in enumerate(jobs):
        job = dict(job, coordinator=coordinator, machine_ranks=len(jobs),
                   out=os.path.join(tmp, f"rank{i}.json"))
        path = os.path.join(tmp, f"job{i}.json")
        with open(path, "w") as f:
            json.dump(job, f)
        logf = open(os.path.join(tmp, f"rank{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), TP_RANK_FLAG, path],
            stdout=logf, stderr=subprocess.STDOUT), logf, job))
    t0 = time.perf_counter()
    fault = None
    try:
        while fault is None and any(p.poll() is None for p, _, _ in procs):
            bad = [p.returncode for p, _, _ in procs if p.poll() not in (None, 0)]
            if bad:
                fault = f"a rank exited with {bad[0]}"
            elif time.perf_counter() - t0 > TP_RANK_TIMEOUT:
                fault = f"the ranks ran past {TP_RANK_TIMEOUT} s"
            else:
                time.sleep(0.5)
        if fault is None and any(p.returncode for p, _, _ in procs):
            fault = f"exit codes {[p.returncode for p, _, _ in procs]}"
    finally:
        for p, logf, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    if fault is not None:
        for i in range(len(jobs)):
            with open(os.path.join(tmp, f"rank{i}.log")) as f:
                log(f"[tp] {label} rank {i} log (tail):\n{f.read()[-6000:]}")
        raise AssertionError(f"{label}: {fault}")
    results = []
    for _, _, job in procs:
        with open(job["out"]) as f:
            results.append(json.load(f))
    shutil.rmtree(tmp)
    log(f"[tp] {label}: {len(jobs)} ranks done in {time.perf_counter() - t0:.1f} s")
    return results


def tp_rank(job_path):
    """A rank of phases 15 and 16: join the job, run its mode, write its
    result."""
    import torch
    import torch.distributed as dist

    from freeze_omni_tpu_torch.parallel import multihost as mh

    with open(job_path) as f:
        job = json.load(f)
    # the ranks share this machine's cores (the host frontend, gloo)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["machine_ranks"]))
    if job["hosts"] > 1:
        # one rank a host, the serve --coordinator layout; here the "hosts"
        # are processes of this machine, which share its cards
        n = torch.cuda.device_count()
        dev = mh.initialize(*mh.resolve_job(job["coordinator"], job["hosts"],
                                            job["host_id"]),
                            device=f"{TP_DEVICE}:{job['host_id'] % n}",
                            backend=mh.choose_backend(TP_DEVICE, job["hosts"]))
    else:                  # one host, local ranks: the serve --tp layout
        dev = mh.initialize(job["coordinator"], 1, 0, job["local_ranks"],
                            job["local_rank"], TP_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(dev)}
    if job["mode"] in ("dp", "forward"):   # phase 16 makes its own meshes
        out.update({"dp": dp_rank, "forward": forward_rank}[job["mode"]](job, dev))
    else:
        mesh = mh.make_global_mesh(("data", "model"), model_par=job["model"])
        out["mesh"] = list(mesh.shape)
        out.update({"parity": tp_rank_parity, "serve": tp_rank_serve}[job["mode"]](
            job, mesh, dev))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(job["out"], "w") as f:
        json.dump(out, f)
    mh.sync("rank done")
    mh.shutdown()
    return 0


def tp_ticks(engine, cfg, n_ticks):
    """Phase 4's dual ticks of two sessions (dev-wav fbank windows): the
    user predictions and the KV lengths of every slot after each tick."""
    sids = ["p0", "p1"]
    for sid in sids:
        engine.open_session(sid)
    feeds = session_feeds(cfg.duplex.gating, len(sids), n_ticks)
    ticks, lengths = [], []
    for tick in range(n_ticks):
        submit_tick((engine,), sids, feeds, tick)
        ticks.append({str(k): v for k, v in engine.tick().get("user", {}).items()})
        lengths.append([int(x) for x in engine.store.lengths()])
    return {"ticks": ticks, "lengths": lengths}


def tp_parity_engine(bits, device, mesh=None):
    import torch

    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parity_config()
    params = audio_llm.init_params(cfg.audio_llm, seed=1, device=device,
                                   quantize_llm=True, quant_bits=bits)
    return cfg, ServingEngine(cfg, params, device=device, mesh=mesh)


def tp_rank_parity(job, mesh, dev):
    import gc

    import torch

    out = {}
    for bits in (8, 4):
        cfg, engine = tp_parity_engine(bits, dev, mesh)
        zero_launches()
        out[f"int{bits}"] = dict(tp_ticks(engine, cfg, TP_PARITY_TICKS),
                                 launches=read_launches())
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_serve_parts(device):
    """The int4 server's config, LLM and speech weights, drawn as
    bin/serve.Server draws them for SERVE_ARGV (flagship, --quant 4
    --kv_quant 8 --max_sessions 8 --respond --seed 0)."""
    import dataclasses

    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.models import audio_llm
    from freeze_omni_tpu_torch.models import codec as codec_mod
    from freeze_omni_tpu_torch.models import speech_decoder as sd

    cfg = flagship_system()
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, max_sessions=8, pipeline_ticks=False, kv_quant_bits=8))
    params = audio_llm.init_params(cfg.audio_llm, seed=0, device=device,
                                   llm_dtype=torch.bfloat16, quantize_llm=True,
                                   quant_bits=4)
    params = audio_llm.cast_frontend(params, torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(7)
    tts = {"decoder": sd.init_params(cfg.tts.decoder, g, device=device),
           "codec": codec_mod.init_params(cfg.tts.codec, g, device=device)}
    return cfg, params, tts


def tp_rank_serve(job, mesh, dev):
    """Phase 9's traffic through DuplexService(engine=PrimaryDriver(...))
    on rank 0; the other ranks replay it (run_follower)."""
    import gc

    import torch

    from freeze_omni_tpu_torch.runtime.engine import ServingEngine
    from freeze_omni_tpu_torch.runtime.multihost_serving import (PrimaryDriver,
                                                                 run_follower)

    torch.backends.cudnn.allow_tf32 = True   # serving default
    cfg, params, tts = tp_serve_parts(dev)
    engine = ServingEngine(cfg, params, seed=0, kv_dtype=torch.bfloat16,
                           device=dev, mesh=mesh)
    del params   # the full tree: the engine keeps this rank's shard
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    # the draw's peak (the full tree before the cut), then what stays
    memory = {"draw_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "resident_gib": torch.cuda.memory_allocated() / 2**30}
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out = {}
    if mesh.rank == 0:
        drv = PrimaryDriver(engine, tts)
        try:
            out = tp_traffic(drv, cfg, tts, job["steps"])
        finally:
            drv.stop()   # releases the followers whatever happened here
    else:
        run_follower(engine, tts)
    out["launches"] = read_launches()
    return dict(out, **memory)


def tp_traffic(drv, cfg, tts, max_steps):
    """Phase 9's traffic on a DuplexService over `drv`: 8 users stream
    speech, the system line a quiet noise; once every user's first IPU has
    closed, one step at threshold 0 makes the sessions inside their next
    IPU speak, then the service runs their rounds and pooled sentences to
    the end. Returns the steps' times and kinds; raises on a missing event,
    an error event or bad audio."""

    import numpy as np
    import torch

    from freeze_omni_tpu_torch.runtime.service import DuplexService

    svc = DuplexService(cfg, engine=drv, seed=0, tts_params=tts)
    texts, count = fixed_sentences(), itertools.count()
    prepare = svc._prepare_sentence
    svc._prepare_sentence = lambda text, hids: prepare(
        texts[next(count) % len(texts)], hids)
    activity = {"respond": 0, "continue": 0, "pool": 0}

    def counted(fn, key, when=lambda: True):
        def run(*a, **k):
            if when():
                activity[key] += 1
            return fn(*a, **k)
        return run

    pool = svc._tts
    drv.respond_fast_many = counted(drv.respond_fast_many, "respond")
    drv.continue_segments_submit = counted(drv.continue_segments_submit, "continue")
    pool.step_submit = counted(pool.step_submit, "pool", when=lambda: bool(pool.jobs))
    svc.resp_threshold = 2.0
    sids = [f"u{i}" for i in range(cfg.serving.max_sessions)]
    sinks = {sid: svc.open_session(sid) for sid in sids}
    n = cfg.duplex.gating.samples_per_chunk
    users = user_streams(len(sids), n)
    rng = np.random.RandomState(0)

    def events(sid, name, identity=None):
        return [e for e in sinks[sid].events_of(name)
                if identity is None or e.get("identity") == identity]

    steps, trigger, responders, pos = [], None, [], 0
    for k in range(max_steps):
        talking = trigger is None
        for i, sid in enumerate(sids):
            chunk = users[i][pos:pos + n] if talking else np.zeros(0, np.float32)
            chunk = np.concatenate([chunk, np.zeros(n - len(chunk), np.float32)])
            svc.enqueue_audio_data(sid, "user", {"audio": chunk})
            svc.enqueue_audio_data(sid, "system", {
                "audio": (LINE_NOISE * rng.randn(n)).astype(np.float32)})
        pos += n
        closed = all(any(e["status"] == "ipu_el"
                         for e in events(sid, "vad_event", "user")) for sid in sids)
        in_ipu = sum(svc.sessions[sid].vad["user"].in_speech for sid in sids)
        fire = talking and closed and (in_ipu >= len(sids) // 2 or
                                       (in_ipu and k >= 120))
        if fire:
            svc.resp_threshold = 0.0
        for key in activity:
            activity[key] = 0
        t0 = time.perf_counter()
        svc.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if fire:
            svc.resp_threshold = 2.0
            trigger = k
            responders = [sid for sid in sids if events(sid, "response_audio")]
            if not responders:
                raise AssertionError("the threshold-0 step made no session speak")
        steps.append({"ms": ms, "kind": "response" if any(activity.values())
                      else "tick", **dict(activity)})
        if trigger is not None and k > trigger and pool.n_active == 0 and all(
                fe.resp is None and fe.tts_key is None and not fe.tts_queue
                for fe in svc.sessions.values()):
            break
    else:
        raise AssertionError(f"the response did not finish in {max_steps} steps")
    svc.flush_tts()
    for sid in sids:
        st = [e["status"] for e in events(sid, "vad_event", "user")]
        if "ipu_sl" not in st or "ipu_el" not in st:
            raise AssertionError(f"{sid}: user VAD events {st}")
        upd = events(sid, "dialog_state_update")
        if not upd or not all(np.isfinite([u["probs"]["state_1"],
                                           u["probs"]["state_2"]]).all() for u in upd):
            raise AssertionError(f"{sid}: no finite dialog_state_update")
        if events(sid, "error"):
            raise AssertionError(f"{sid}: error events {events(sid, 'error')}")
    for sid in responders:
        for a in events(sid, "response_audio"):
            if not (np.isfinite(a["pcm"]).all()
                    and np.abs(a["pcm"]).max(initial=0.0) <= 1.0):
                raise AssertionError(f"{sid}: response PCM not finite or outside [-1, 1]")
    if not any(a["sr"] == 16000 for sid in responders
               for a in events(sid, "response_audio")):
        raise AssertionError("no pooled sentence audio")
    return {"tick_ms": [s["ms"] for s in steps if s["kind"] == "tick"],
            "response_ms": [s["ms"] for s in steps if s["kind"] == "response"],
            "steps": len(steps), "trigger": trigger, "responders": len(responders),
            "responder_slots": [drv.store.slot_of(sid) for sid in responders],
            "rounds": sum(s["continue"] for s in steps)}


def phase_tp_parity(smi):
    """15a: two ranks on the card (and four, on a host with four cards),
    tp = 2 (4), at Qwen2-7B width cut to 2 LLM layers, int8 and int4,
    against the single-rank engine on the card."""
    import gc

    import torch

    thr = parity_config().duplex.resp_threshold
    want = {}
    for bits in (8, 4):
        cfg, engine = tp_parity_engine(bits, "cuda")
        want[bits] = tp_ticks(engine, cfg, TP_PARITY_TICKS)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    for tp in [t for t in (2, 4) if t == 2 or t <= torch.cuda.device_count()]:
        ranks = run_ranks([{"mode": "parity", "hosts": 1, "local_ranks": tp,
                            "local_rank": r, "model": tp} for r in range(tp)],
                          f"15a parity tp={tp}")
        tp_parity_check(ranks, want, tp, thr, smi)


def tp_parity_check(ranks, want, tp, thr, smi):
    import numpy as np

    backend, per_card = tp_layout(tp)
    for bits in (8, 4):
        worst, compared = 0.0, 0
        for r in ranks:
            got = r[f"int{bits}"]
            if got["lengths"] != want[bits]["lengths"]:
                raise AssertionError(f"int{bits} rank {r['rank']}: KV lengths "
                                     f"{got['lengths']} vs {want[bits]['lengths']}")
            for t, (gt, wt) in enumerate(zip(got["ticks"], want[bits]["ticks"])):
                if sorted(gt) != sorted(wt):
                    raise AssertionError(f"int{bits} tick {t}: predicted slots differ")
                for slot, pw in wt.items():
                    for key in ("state_1", "state_2"):
                        pg, pc = gt[slot][key], pw[key]
                        worst = max(worst, abs(pg - pc))
                        compared += 1
                        if not (np.isfinite(pg) and abs(pg - pc) <= TP_PARITY_ATOL):
                            raise AssertionError(
                                f"int{bits} rank {r['rank']} tick {t} slot {slot} "
                                f"{key}: tp={tp} {pg} vs one rank {pc}")
                        if abs(pc - thr) > TP_PARITY_ATOL and (pg > thr) != (pc > thr):
                            raise AssertionError(f"int{bits} tick {t}: decision differs")
            for key in ("quant_matmul" if bits == 8 else "quant_matmul4", "prefill_quant"):
                if not got["launches"][key]:
                    raise AssertionError(f"int{bits} rank {r['rank']}: {key} not launched")
        if not compared:
            raise AssertionError(f"int{bits}: no user prediction was compared")
        if any(r[f"int{bits}"]["ticks"] != ranks[0][f"int{bits}"]["ticks"]
               for r in ranks):
            raise AssertionError(f"int{bits}: the ranks' predictions differ")
        log(f"[tp] 15a int{bits} weights, 2-layer flagship widths, tp={tp} on "
            f"{backend} ({per_card} ranks per card; {smi}): {TP_PARITY_TICKS} dual "
            f"ticks x 2 sessions against one rank on the card: max |dprob| "
            f"{worst:.3e} over {compared} probabilities (atol {TP_PARITY_ATOL}); "
            f"decisions and KV lengths equal; "
            f"every rank's predictions identical")


def tp_serve_report(label, ranks, smi):
    """Check and print a serving run: every rank's K1/K2/K4/K5 launches,
    peak memory, step times. Every rank runs the tick (K5's tile path, K2);
    a rank whose rows hold a speaking session runs its response (K1 in the
    int8 lm_head, K5's small-N path in the text decode, K4 in the speech
    decoder), which under 'data' > 1 is not every rank."""
    import torch

    backend = ranks[0]["backend"]
    per_card = 1 if backend == "nccl" else -(-len(ranks) // torch.cuda.device_count())
    p = ranks[0]
    data = p["mesh"][0]
    rows = 8 // data   # tp_serve_parts serves 8 sessions
    speaking = {slot // rows for slot in p["responder_slots"]}
    for r in ranks:
        need = ["prefill_quant", "quant_matmul4"]
        if r["rank"] // p["mesh"][1] in speaking:
            need += ["quant_matmul", "decode_attention_blocked", "quant_matmul4_small"]
        for key in need:
            if not r["launches"][key]:
                raise AssertionError(f"{label} rank {r['rank']}: {key} not launched")
        log(f"[tp] {label} rank {r['rank']} mesh {r['mesh']} on {r['device']}: "
            f"launches {r['launches']}; device memory: the weights' draw peak "
            f"{r['draw_peak_gib']:.2f} GiB (the full tree before the cut), "
            f"resident after the cut {r['resident_gib']:.2f} GiB, serving peak "
            f"{r['peak_gib']:.2f} GiB")
    log(f"[tp] {label} ({backend}, {per_card} ranks per card, {smi}): "
        f"{p['steps']} steps, threshold-0 step {p['trigger']}, {p['responders']} "
        f"sessions spoke, {p['rounds']} continuation rounds; tick-only step "
        f"(first 5 excluded) {pct(p['tick_ms'][5:])}; steps with response work "
        f"{pct(p['response_ms'])}" + ("" if backend == "nccl" else
                                      "; ranks sharing one card: not a TP speed"))
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def phase_tp_serve(smi):
    """15b: phase 9's traffic at full width and depth, tp = 2, through
    DuplexService(engine=PrimaryDriver(...)) and the follower; 15c: the
    same with (data 2, model 1), two "hosts" joined the serve
    --coordinator way."""
    import torch

    n = torch.cuda.device_count()
    backend, per_card = tp_layout(2)
    log(f"[tp] {n} card(s); 2 local ranks take {backend} with {per_card} "
        f"rank(s) per card")
    if n < 2:
        log("[tp] one card on this host: no NCCL run (NCCL refuses two ranks on "
            "one device); the TP step times below are ranks sharing the card")
    b = run_ranks([{"mode": "serve", "hosts": 1, "local_ranks": 2, "local_rank": r,
                    "model": 2, "steps": TP_SERVE_STEPS} for r in range(2)],
                  "15b tp=2 serving")
    launches = tp_serve_report("15b (data 1, model 2)", b, smi)
    c = run_ranks([{"mode": "serve", "hosts": 2, "host_id": r, "model": 1,
                    "steps": TP_SERVE_STEPS} for r in range(2)],
                  "15c two-host serving")
    for k, v in tp_serve_report("15c (data 2, model 1)", c, smi).items():
        launches[k] += v
    # 15e, where every rank can have a card: the same traffic on one rank
    # and, with four cards, at tp = 4, to read 15b against (one call, one host)
    for tp in [t for t in (1, 4) if n >= 2 and t <= n]:
        e = run_ranks([{"mode": "serve", "hosts": 1, "local_ranks": tp,
                        "local_rank": r, "model": tp, "steps": TP_SERVE_STEPS}
                       for r in range(tp)], f"15e tp={tp} serving")
        for k, v in tp_serve_report(f"15e (data 1, model {tp})", e, smi).items():
            launches[k] += v
    return launches


def tp_k2_cache(B, T, H, Hkv, S, kind, seed):
    """K2's inputs at a shard shape as a one-layer cache and its qend."""
    from freeze_omni_tpu_torch.models.qwen2 import KVCache

    _, k_q, k_s, v_q, v_s, qend = k2_inputs(B, T, H, Hkv, 128, S, seed, kind)
    return KVCache(k=k_q[None], v=v_q[None], length=qend[:, -1],
                   k_scale=k_s[None], v_scale=v_s[None]), qend


def phase_tp_kernel_times(kernels, smi):
    """15d: K1 and K5 on one layer's 7 projections at N = 232 and N = 8
    (K1 with the int8 lm_head at N = 8), and K2 at the tick (T = 29) and a
    text step (T = 1), at the shapes one rank of tp = 2 and of tp = 4 runs
    (parallel/mesh.shard_llm_tree of a one-layer flagship-width tree), each
    beside its bound, its plain version and the library call."""
    import dataclasses
    import gc

    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.ops.quant import init_quantized_llm
    from freeze_omni_tpu_torch.parallel.mesh import shard_llm_tree

    cfg = flagship_system().audio_llm.llm
    one = dataclasses.replace(cfg, num_layers=1)
    g = torch.Generator(device="cuda").manual_seed(15)
    out = {"quant_matmul": {}, "quant_matmul4": {}, "prefill_quant": {}}

    def short(t):
        return {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "library_device_ms")
                if k in t}

    for bits, key in ((8, "quant_matmul"), (4, "quant_matmul4")):
        llm = init_quantized_llm(one, g, "cuda", bits=bits)
        for tp in TP_SHARD_WAYS:
            shard = shard_llm_tree({k: v for k, v in llm.items()}, 0, tp)
            if bits == 8:
                tick = k1_layer(shard["layers"], None, 232, g)
                step = k1_layer(shard["layers"], shard["lm_head"], 8, g)
            else:
                tick = k5_layer(shard["layers"], 232, g)
                step = k5_layer(shard["layers"], 8, g)
            for label, t in (("7 projections at N=232", tick),
                             ("7 projections" + (" + lm_head" if bits == 8 else "")
                              + " at N=8", step)):
                log(f"[tp] 15d K{1 if bits == 8 else 5} tp={tp} one layer's {label} "
                    f"({smi}): kernel {t['ms']:.4f} ms eager, {t['device_ms']:.4f} "
                    f"device, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                    f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms"
                    + (f" (device {t['library_device_ms']})"
                       if "library_device_ms" in t else ""))
            out[key][f"tp{tp}"] = {"N232": short(tick), "N8": short(step)}
            del shard
        del llm
        gc.collect()
        torch.cuda.empty_cache()
    for tp in TP_SHARD_WAYS:
        H, Hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
        res = {}
        for label, T, kind in (("T29", 29, "tick"), ("T1", 1, "text")):
            kv, qend = tp_k2_cache(8, T, H, Hkv, 1024, kind, seed=tp)
            r = k2_time(kv, qend, H, g)
            log(f"[tp] 15d K2 tp={tp} B=8 {label} H={H} Hkv={Hkv} S=1024 "
                f"({smi}), {r['splits']} splits: kernel {r['ms']:.4f} ms eager, "
                f"{r['device_ms']:.4f} device, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library none "
                f"(SDPA on bf16 K/V {r['sdpa_bf16_ms']:.4f} ms device: a ceiling)")
            res[label] = dict(short(r), sdpa_bf16_ms=r["sdpa_bf16_ms"])
            del kv, qend
        out["prefill_quant"][f"tp{tp}"] = res
    for entry in kernels:
        key = entry["name"].split(" ")[0]
        if key in out:
            entry["tp_shard_shapes"] = out[key]


# ---------------------------------------------------------------------------
# phase 16: multi-GPU training (bin/train.py data-parallel, ring attention,
# the GPipe pipeline)
# ---------------------------------------------------------------------------

DP_BATCH = 4
DP_STEPS = 4
DP_LOSS_RTOL = 1e-5      # every DP loss against one rank's, relative
# 16a's AdamW lr. DP and one rank sum a step's gradients in different
# orders, so an entry whose gradient is rounding noise takes an Adam step
# of up to lr either way in each run: after one step the runs' parameters
# part by 0.85-1.14 lr (measured at lr 1e-3, 1e-4 and 1e-5 on an H100
# 80GB HBM3 at 700 W), and an entry parted so keeps that gap when its
# gradient is resolved later. At lr = 1e-5 / 2 that one-step bound, 2 lr,
# is phase 14's 1e-5 itself, so the rule holds after four steps too.
DP_LR = 5e-6
DP_SHARED_DEPTH = 20     # LLM layers when two ranks' f32 trees share one card
RING_T = 4096            # 16c: B = 1 sequences of 4096 tokens
RING_WAYS = (2, 4)
PIPE_STAGES = 4          # 16d: 7 layers a stage
PIPE_MICRO = 4           # microbatches of b = 1
PIPE_T = 512
SP_PP_NS = (2048, 512)   # 16e: a ring rank's rows at R = 2, a microbatch's
FORWARD_SEED = 16
SHIFT_ROUNDS = 10        # ring rotations timed alone


def dp_argv(stage, steps, *extra, lr=DP_LR):
    return ["--preset", "flagship", "--stage", stage, "--batch", str(DP_BATCH),
            "--steps", str(steps), "--seed", "0", "--lr", str(lr), *extra]


def dp_system(depth):
    """flagship_system() with the LLM cut to `depth` layers."""
    import dataclasses

    from freeze_omni_tpu_torch.config import flagship_system

    cfg = flagship_system()
    llm = dataclasses.replace(cfg.audio_llm.llm, num_layers=depth)
    return dataclasses.replace(cfg, audio_llm=dataclasses.replace(cfg.audio_llm,
                                                                  llm=llm))


def dp_train(argv, depth):
    """bin/train.run at `depth` LLM layers (in the job this process joined,
    if any): its output without the state, the peak memory, the final
    trainable tree and its last gradients (on the host)."""
    import gc

    import torch

    from freeze_omni_tpu_torch.bin import train
    from freeze_omni_tpu_torch.training import optim

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = train.run(train.get_args(argv), system=dp_system(depth))
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    state = out.pop("state")
    params = optim.map_tree(lambda p: p.detach().cpu(), state.trainable)
    grads = optim.map_tree(lambda p: p.grad.detach().cpu(), state.trainable)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out, params, grads


def dp_rank(job, dev):
    """A rank of 16a: the job's bin/train runs in this process's job; rank
    0 saves each run's final trainable tree and its last (summed)
    gradients."""
    from freeze_omni_tpu_torch import weights
    from freeze_omni_tpu_torch.utils.checkpoint import save_native

    zero_launches()
    runs = {}
    for name, argv in job["runs"]:
        out, params, grads = dp_train(argv, job["depth"])
        if out["rank"] == 0 and name in job["save"]:
            for what, tree in (("params", params), ("grads", grads)):
                save_native(os.path.join(job["dir"], f"{name}.{what}.npz"),
                            weights.to_numpy(tree))
        runs[name] = {k: out[k] for k in ("losses", "step_seconds", "peak_gib",
                                          "param_checksum", "host_id", "final_step")}
    return {"runs": runs, "launches": read_launches()}


def phase_dp_training(smi, lr=DP_LR):
    """16a: bin/train.py data-parallel over two ranks (gloo sharing the card
    on a one-card host, NCCL with a card each) at Qwen2-7B widths, --stage
    state then all, batch 4, AdamW at `lr`, against one rank on the whole
    batch, after one step and after four: every loss within DP_LOSS_RTOL,
    the parameters within phase 14's rule (1e-5 where the last gradient is
    resolved, 2 lr elsewhere), and after one step the gradients within
    phase 14's rule; then a resume on both ranks from the four-step state
    run's step-3 checkpoint."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from freeze_omni_tpu_torch import weights
    from freeze_omni_tpu_torch.training import optim
    from freeze_omni_tpu_torch.utils.checkpoint import load_native

    n = torch.cuda.device_count()
    depth = 28 if n >= 2 else DP_SHARED_DEPTH
    backend, per_card = tp_layout(2)
    tmp = tempfile.mkdtemp(prefix="dp-")
    ck = os.path.join(tmp, "ck")
    runs = [(f"{stage}{steps}", stage, steps) for steps in (1, DP_STEPS)
            for stage in ("state", "all")]
    jobs = [(name, dp_argv(stage, steps, *(("--ckpt_dir", ck, "--save_every", "3")
                                           if name == f"state{DP_STEPS}" else ()),
                           lr=lr))
            for name, stage, steps in runs]
    jobs.append(("resume", dp_argv("state", 1, "--ckpt_dir", ck, "--save_every",
                                   "3", "--resume", lr=lr)))
    ref = {}
    for name, stage, steps in runs:   # one rank on the whole batch, first
        out, params, grads = dp_train(dp_argv(stage, steps, lr=lr), depth)
        ref[name] = (out, params, grads)
        log(f"[dp] ({smi}) one rank, --stage {stage}, batch {DP_BATCH}, {steps} "
            f"step(s), lr {lr}, LLM depth {depth}: losses {out['losses']}; s/step "
            f"{np.median(out['step_seconds'][1:] or out['step_seconds']):.4f} "
            f"median; peak {out['peak_gib']:.2f} GiB")
    ranks = run_ranks([{"mode": "dp", "hosts": 2, "host_id": r, "model": 1,
                        "depth": depth, "runs": jobs, "save": [r[0] for r in runs],
                        "dir": tmp} for r in range(2)], "16a data-parallel training")
    for name, stage, steps in runs:
        out, params, grads = ref[name]
        got = [r["runs"][name] for r in ranks]
        rels = np.abs(np.array([g["losses"] for g in got]) - out["losses"]) \
            / np.abs(out["losses"])
        rel = float(rels.max())
        sums = {g["param_checksum"] for g in got}
        mine, my_grads = (weights.from_jax(load_native(os.path.join(
            tmp, f"{name}.{what}.npz")), device="cpu") for what in ("params", "grads"))
        g_err = worst_grad_err(optim.leaves(my_grads), optim.leaves(grads))
        worst_res, worst = params_after_step_agree(mine, params, grads)
        if steps > 1:
            for r, g in zip(ranks, got):
                log(f"[dp] ({smi}) rank {r['rank']} ({backend}, {per_card} ranks a "
                    f"card), --stage {stage}: s/step {np.median(g['step_seconds'][1:]):.4f} "
                    f"median ({min(g['step_seconds']):.4f}-{max(g['step_seconds']):.4f}); "
                    f"peak {g['peak_gib']:.2f} GiB; checksum {g['param_checksum']}")
        log(f"[dp] ({smi}) 16a --stage {stage}, {steps} step(s), lr {lr}, 2 ranks x "
            f"{DP_BATCH // 2} rows against one rank x {DP_BATCH}, LLM depth {depth}: "
            f"losses {got[0]['losses']}, within {rel:.2e} relative (tol "
            f"{DP_LOSS_RTOL}, per step {[float(f'{x:.2e}') for x in rels.max(0)]}); "
            f"last gradients within {g_err:.2e} of each leaf's largest "
            + (f"(tol {TRAIN_GRAD_FRAC})" if steps == 1 else
               "(not held: the parameters they follow differ by up to 2 lr)")
            + f"; params within {worst_res:.2e} where the last "
            f"gradient is resolved (tol {TRAIN_PARAM_ATOL}), {worst:.2e} anywhere "
            f"(tol {2 * lr}); checksums {sorted(sums)}")
        if not rel <= DP_LOSS_RTOL:
            raise AssertionError(f"16a {name}: DP losses differ from one rank's")
        if len(sums) != 1:
            raise AssertionError(f"16a {name}: the ranks' parameters differ")
        if steps == 1 and not g_err <= TRAIN_GRAD_FRAC:
            raise AssertionError(f"16a {name}: DP gradients differ from one "
                                 f"rank's by {g_err}")
        if not (worst_res <= TRAIN_PARAM_ATOL and worst <= 2 * lr):
            raise AssertionError(f"16a {name}: DP parameters differ from one "
                                 f"rank's by {worst_res} (resolved) / {worst}")
    full = ranks[0]["runs"][f"state{DP_STEPS}"]["losses"]
    for r in ranks:
        res = r["runs"]["resume"]
        rel = abs(res["losses"][0] - full[3]) / abs(full[3])
        log(f"[dp] ({smi}) rank {r['rank']} resumed from step 3: step 4 loss "
            f"{res['losses'][0]} against the uninterrupted {full[3]} (rel {rel:.2e})")
        if res["final_step"] != DP_STEPS or not rel <= RESUME_RTOL:
            raise AssertionError("16a: the DP resume does not continue the run")
        if any(r["launches"].values()):
            raise AssertionError("16a: training launched a serving kernel")
    shutil.rmtree(tmp)


def phase_dp_cli(smi):
    """16b: bin/train.py --preset flagship --stage state at full depth, one
    rank a card, where the host has two or more cards."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[dp] 16b not run: {n} card on this host, and bin/train.py's "
            f"data-parallel mode takes one card a rank (two ranks sharing a "
            f"card ran in 16a)")
        return
    argv = ["--preset", "flagship", "--stage", "state", "--steps", "3",
            "--batch", str(2 * n)]
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "freeze_omni_tpu_torch.bin.train",
                        *argv], capture_output=True, text=True,
                       timeout=TP_RANK_TIMEOUT)
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    log(f"[dp] ({smi}) 16b bin/train.py {' '.join(argv)} over {n} cards: exit "
        f"{p.returncode} in {time.perf_counter() - t:.1f} s; summaries {lines}")
    if p.returncode or len(lines) != n or len({x["param_checksum"] for x in lines}) != 1:
        raise AssertionError(f"16b: the data-parallel CLI failed:\n{p.stderr[-4000:]}")


def forward_inputs(llm, cfg, seed):
    """16c's and 16d's embeddings, looked up in the tree's int8 table:
    [1, RING_T] and [PIPE_MICRO, PIPE_T] seeded token ids."""
    import numpy as np
    import torch

    from freeze_omni_tpu_torch.models import qwen2

    rng = np.random.RandomState(seed)
    dev = llm["final_norm"]["scale"].device
    ids = [torch.from_numpy(rng.randint(0, cfg.vocab_size, size=s)).to(dev)
           for s in ((1, RING_T), (PIPE_MICRO, PIPE_T))]
    return [qwen2.embed_tokens(llm, i) for i in ids]


def forward_tree(bits, device):
    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.ops.quant import init_quantized_llm

    import torch

    cfg = flagship_system().audio_llm.llm
    llm = init_quantized_llm(cfg, torch.Generator(device=device).manual_seed(
        FORWARD_SEED + bits), device, bits=bits)
    return cfg, llm


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    y = fn()
    torch.cuda.synchronize()
    return y, (time.perf_counter() - t) * 1e3


def forward_rank(job, dev):
    """A rank of 16c/16d: for int8 then int4, sp_forward on this rank's
    slice at R = 4 (('seq',)) and R = 2 (data index 0 of a (data 2, seq 2)
    mesh; data index 1 waits), then pp_forward over 4 stages with this
    rank's stage_tree only. Each forward runs twice: the first's launches,
    peak and output, the second's time."""
    import gc

    import torch
    import torch.distributed as dist

    from freeze_omni_tpu_torch.parallel import collectives
    from freeze_omni_tpu_torch.parallel import mesh as pmesh
    from freeze_omni_tpu_torch.parallel.pipeline_parallel import (pp_forward,
                                                                   stage_tree)
    from freeze_omni_tpu_torch.parallel.ring_attention import seq_slice, sp_forward

    rings = {4: pmesh.make_mesh((4,), ("seq",)),
             2: pmesh.make_mesh((2, 2), ("data", "seq"))}
    stages = pmesh.make_mesh((PIPE_STAGES,), ("stage",))
    out = {}
    for bits in (8, 4):
        cfg, llm = forward_tree(bits, dev)
        x_ring, x_pipe = forward_inputs(llm, cfg, FORWARD_SEED)
        params = {"layers": llm["layers"], "final_norm": llm["final_norm"]}
        del llm
        gc.collect()
        torch.cuda.empty_cache()
        for R, mesh in rings.items():
            res = {}
            if mesh.data_index == 0:
                x = seq_slice(x_ring, mesh)
                torch.cuda.reset_peak_memory_stats()
                zero_launches()
                y, ms = timed(lambda: sp_forward(params, cfg, x, mesh))
                res = {"launches": read_launches(), "first_ms": ms,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                _, res["ms"] = timed(lambda: sp_forward(params, cfg, x, mesh))
                # one round's rotation of a K and a V block, alone
                kv = [torch.zeros((1, RING_T // R, cfg.num_kv_heads, cfg.head_dim),
                                  dtype=torch.bfloat16, device=dev)] * 2
                group = mesh.axis_group("seq")
                collectives.ring_shift(kv, group)
                _, ms = timed(lambda: [collectives.ring_shift(kv, group)
                                       for _ in range(SHIFT_ROUNDS)])
                res["shift_ms"] = ms / SHIFT_ROUNDS
                torch.save(y.cpu(), os.path.join(job["dir"], f"ring{R}_int{bits}_"
                                                             f"r{dist.get_rank()}.pt"))
                del y, x
            dist.barrier()   # the waiting data index
            out[f"ring{R}_int{bits}"] = res
        stage = stage_tree(params, stages.axis_index("stage"), PIPE_STAGES)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        res = {"resident_gib": torch.cuda.memory_allocated() / 2**30}
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        y, res["first_ms"] = timed(lambda: pp_forward(stage, cfg, x_pipe, stages,
                                                      PIPE_MICRO))
        res["launches"] = read_launches()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        _, res["ms"] = timed(lambda: pp_forward(stage, cfg, x_pipe, stages,
                                                PIPE_MICRO))
        torch.save(y.cpu(), os.path.join(job["dir"], f"pipe_int{bits}_"
                                                     f"r{dist.get_rank()}.pt"))
        out[f"pipe_int{bits}"] = res
        del stage, y, x_ring, x_pipe
        gc.collect()
        torch.cuda.empty_cache()
    return out


def row_err(out, ref):
    """Worst |out - ref| over each row's largest |ref|, over the rows."""
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


def phase_sp_pp(smi):
    """16c/16d: sp_forward (R = 2, 4) and pp_forward (P = 4, M = 4) at
    Qwen2-7B width and depth, int8 then int4, bf16 activations, against the
    unsharded causal forward (qwen2.train_forward) on one rank."""
    import gc
    import shutil
    import tempfile

    import torch

    from freeze_omni_tpu_torch.models import qwen2

    backend, per_card = tp_layout(4)
    ref = {}
    for bits in (8, 4):
        cfg, llm = forward_tree(bits, "cuda")
        x_ring, x_pipe = forward_inputs(llm, cfg, FORWARD_SEED)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        for name, x in (("ring", x_ring), ("pipe", x_pipe)):
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                y, ms = timed(lambda: qwen2.train_forward(llm, cfg, x))
            ref[f"{name}_int{bits}"] = (y.cpu(), ms, resident,
                                        torch.cuda.max_memory_allocated() / 2**30)
            log(f"[sp-pp] ({smi}) unsharded forward, int{bits}, {tuple(x.shape)} "
                f"bf16: {ms:.1f} ms (first call), resident {resident:.2f} GiB "
                f"(the whole tree), peak {ref[f'{name}_int{bits}'][3]:.2f} GiB")
            del y
        del llm, x_ring, x_pipe
        gc.collect()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="sp-pp-")
    ranks = run_ranks([{"mode": "forward", "hosts": 1, "local_ranks": 4,
                        "local_rank": r, "model": 1, "dir": tmp} for r in range(4)],
                      "16c/16d ring attention and pipeline")
    launches = {}
    per_forward = 7 * cfg.num_layers
    for bits in (8, 4):
        key = "quant_matmul" if bits == 8 else "quant_matmul4"
        other = "quant_matmul4" if bits == 8 else "quant_matmul"
        for R in RING_WAYS:
            name = f"ring{R}_int{bits}"
            want, ref_ms, _, ref_peak = ref[f"ring_int{bits}"]
            part = [r for r in ranks if r[name]]
            got = torch.cat([torch.load(os.path.join(tmp, f"{name}_r{r['rank']}.pt"))
                             for r in part], dim=1)
            err = row_err(got, want)
            log(f"[sp-pp] ({smi}) 16c sp_forward R={R}, int{bits}, B=1 T={RING_T} "
                f"bf16 ({backend}, {per_card} ranks a card{'' if R == 4 else '; the other data index waits'}): "
                f"hidden within {err:.3e} of each row's largest (tol {HIDDEN_ROW_TOL}); "
                f"a forward {part[0][name]['ms']:.1f} ms on rank 0, of which "
                f"{(R - 1) * cfg.num_layers} rotations of K and V at "
                f"{part[0][name]['shift_ms']:.2f} ms each alone "
                f"(first {part[0][name]['first_ms']:.1f}; unsharded {ref_ms:.1f} ms, "
                f"first call); peak a rank "
                f"{[round(r[name]['peak_gib'], 2) for r in part]} GiB against the "
                f"unsharded {ref_peak:.2f}; launches {[r[name]['launches'][key] for r in part]}")
            if not err <= HIDDEN_ROW_TOL:
                raise AssertionError(f"16c {name}: the ring's hidden states differ")
            for r in part:
                lc = r[name]["launches"]
                if lc[key] != per_forward or lc[other] or lc["quant_matmul4_small"]:
                    raise AssertionError(f"16c {name} rank {r['rank']}: launches {lc}")
                launches[key] = launches.get(key, 0) + lc[key]
        name = f"pipe_int{bits}"
        want, ref_ms, ref_res, ref_peak = ref[name]
        err = max(row_err(torch.load(os.path.join(tmp, f"{name}_r{r['rank']}.pt")),
                          want) for r in ranks)
        log(f"[sp-pp] ({smi}) 16d pp_forward P={PIPE_STAGES} M={PIPE_MICRO} (b=1, "
            f"T={PIPE_T}), int{bits} bf16 ({backend}, {per_card} ranks a card): every "
            f"rank's hidden within {err:.3e} of each row's largest (tol "
            f"{HIDDEN_ROW_TOL}); a forward {ranks[0][name]['ms']:.1f} ms (first "
            f"{ranks[0][name]['first_ms']:.1f}; unsharded {ref_ms:.1f} ms, first "
            f"call); resident a rank {[round(r[name]['resident_gib'], 2) for r in ranks]} "
            f"GiB and peak {[round(r[name]['peak_gib'], 2) for r in ranks]} GiB against "
            f"the whole tree's {ref_res:.2f} (unsharded peak {ref_peak:.2f}); "
            f"launches {[r[name]['launches'][key] for r in ranks]}")
        if not err <= HIDDEN_ROW_TOL:
            raise AssertionError(f"16d {name}: the pipeline's hidden states differ")
        for r in ranks:
            lc = r[name]["launches"]
            if lc[key] != per_forward // PIPE_STAGES * PIPE_MICRO or lc[other] \
                    or lc["quant_matmul4_small"]:
                raise AssertionError(f"16d {name} rank {r['rank']}: launches {lc}")
            launches[key] = launches.get(key, 0) + lc[key]
    shutil.rmtree(tmp)
    return launches


def phase_sp_pp_kernel_times(kernels, smi):
    """16e: K1 and K5's tile path on one layer's 7 projections at N = 2048
    (a ring rank at R = 2) and N = 512 (a microbatch), each beside its bound,
    its plain version, the library call and a dense bf16 matmul."""
    import dataclasses
    import gc

    import torch

    from freeze_omni_tpu_torch.config import flagship_system
    from freeze_omni_tpu_torch.ops.quant import init_quantized_llm

    one = dataclasses.replace(flagship_system().audio_llm.llm, num_layers=1)
    g = torch.Generator(device="cuda").manual_seed(16)
    out = {"quant_matmul": {}, "quant_matmul4": {}}
    for bits, key in ((8, "quant_matmul"), (4, "quant_matmul4")):
        llm = init_quantized_llm(one, g, "cuda", bits=bits)
        for N in SP_PP_NS:
            # the library call (torch._weight_int8pack_mm) takes ~0.1 s a
            # projection at these N: 3 timed calls
            t = (k1_layer(llm["layers"], None, N, g, lib_iters=3) if bits == 8
                 else k5_layer(llm["layers"], N, g))
            log(f"[sp-pp] 16e K{1 if bits == 8 else 5} one layer's 7 projections "
                f"at N={N} ({smi}): kernel {t['ms']:.4f} ms eager, "
                f"{t['device_ms']:.4f} device, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']} ms"
                + (f" (device {t['library_device_ms']})" if "library_device_ms" in t
                   else "") + f", dense bf16 {t['dense_bf16_ms']:.4f} ms")
            out[key][f"N{N}"] = {k: t[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "dense_bf16_ms") if k in t}
        del llm
        gc.collect()
        torch.cuda.empty_cache()
    for entry in kernels:
        key = entry["name"].split(" ")[0]
        if key in out:
            entry["sp_pp_shapes"] = out[key]


def main() -> int:
    t_start = time.perf_counter()
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the card", file=sys.stderr)
        return 2
    import freeze_omni_tpu_torch  # noqa: F401  (fails outside a checkout)

    # phase 11 reads local HF directories only
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

    name, count, smi = phase_device()
    phase_build()
    errs = phase_kernel_parity()
    gpu, cpu, sids = phase_tick_parity(8)
    phase_response_parity(gpu, cpu, sids)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    phase_tick_parity(4)
    gc.collect()
    torch.cuda.empty_cache()
    engine, sids, launches, per_tick = phase_tick_path()
    int8_llm_bytes = llm_bytes(engine.core.params["llm"])
    resp = phase_response_path(engine, sids, smi)
    kernels = phase_kernel_times(engine, (launches, per_tick), resp, errs, smi)
    del engine, resp
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_service(smi, int8_llm_bytes)
    for entry, key in zip(kernels, ("quant_matmul", "prefill_quant",
                                    "decode_attention", "decode_attention_blocked")):
        entry["launches_int4_service"] = serve["launches"][key]
        entry["launches"] += serve["launches"][key]
    phase_k4_service_times(serve, kernels, smi)
    kernels.insert(1, phase_k5_times(serve, errs, smi))
    service_front = serve["front_ms"]
    del serve
    gc.collect()
    torch.cuda.empty_cache()
    phase_session_parity()
    gc.collect()
    torch.cuda.empty_cache()
    sess = phase_sessions(smi)
    phase_session_one_caller(sess["server"], smi)
    phase_session_kernel_times(sess, kernels, smi)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    zero_launches()
    tiny = phase_trained_tiny(smi)
    ref = phase_reference_checkpoint(smi)
    for entry in kernels:
        key = entry["name"].split(" ")[0]
        n = tiny["launches"][key] + ref["launches"][key]
        entry["launches_phase11"] = n
        entry["launches"] += n
        if key == "decode_attention_blocked":
            entry["tiny_tts"] = {k: tiny["k4_tiny_tts"][k] for k in (
                "ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "splits", "length")}
    del tiny, ref
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    phase_lora_parity(smi)
    gc.collect()
    torch.cuda.empty_cache()
    snap = phase_snapshot_server(smi)
    phase_codec_tool(smi)
    out_cer = phase_out_cer(smi)
    log(f"[phase 12] {time.perf_counter() - t12:.1f} s wall")
    for entry in kernels:
        key = entry["name"].split(" ")[0]
        n = snap["launches"][key] + out_cer[key]
        entry["launches_phase12"] = n
        entry["launches"] += n
    del snap
    gc.collect()
    torch.cuda.empty_cache()
    zero_launches()
    phase_native_frontend(smi, service_front)
    phase_training(smi)   # reads its own launch counts: none may launch
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    phase_tp_parity(smi)
    served = phase_tp_serve(smi)   # the ranks' own counts of the serving runs
    phase_tp_kernel_times(kernels, smi)
    log(f"[phase 15] {time.perf_counter() - t15:.1f} s wall")
    for entry in kernels:
        key = entry["name"].split(" ")[0]
        entry["launches_phase15"] = served[key]
        entry["launches"] += served[key]
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    phase_dp_training(smi)
    phase_dp_cli(smi)
    forwards = phase_sp_pp(smi)   # the ranks' own counts of their forwards
    phase_sp_pp_kernel_times(kernels, smi)
    log(f"[phase 16] {time.perf_counter() - t16:.1f} s wall")
    for entry in kernels:
        key = entry["name"].split(" ")[0]
        entry["launches_phase16"] = forwards.get(key, 0)
        entry["launches"] += forwards.get(key, 0)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == TP_RANK_FLAG:
        sys.exit(tp_rank(sys.argv[2]))   # a rank process of phase 15 or 16
    sys.exit(main())
