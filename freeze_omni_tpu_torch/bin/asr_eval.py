"""Speech-understanding evaluation: CER/WER over a wav + transcript manifest
(counterpart of freeze_omni_tpu/bin/asr_eval.py).

Harness for the reference's ASR benchmark tables (aishell CER / LibriSpeech
WER). Listens to each wav through the streaming pipeline, generates the
text, and scores it against the manifest. With converted reference
checkpoints this reproduces the published evaluation; with random weights it
checks the harness itself.

Manifest: tab-separated lines "path<TAB>transcript".

Usage (the card by default; --device cpu runs the plain PyTorch versions):
  python -m freeze_omni_tpu_torch.bin.asr_eval \\
      --model_path freeze_omni_tpu_torch/assets/tiny_s2s \\
      --manifest freeze_omni_tpu/assets/tiny_s2s/asr_dev.tsv \\
      --char_level --batch 8 --max_tokens 24 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch


def transcribe(pipeline, chunker, wav: np.ndarray, max_tokens: int,
               role: str = "Transcribe the user's speech exactly.") -> str:
    """Listen chunk by chunk, then generate text (the offline stage
    machine). The role prompt selects the task (transcription here;
    bin/qa_eval.py passes an answering prompt)."""
    outputs = pipeline.speech_dialogue(None, stat="pre", role=role)
    chunk = chunker.get_chunk_size()
    n = int(math.ceil(len(wav) / chunk)) * chunk
    padded = np.zeros(n, np.float32)
    padded[: len(wav)] = wav
    for i in range(0, n, chunk):
        outputs = pipeline.speech_dialogue(chunker.process(padded[i : i + chunk]),
                                           **outputs)
        outputs["stat"] = "dialog_cl"
    chunker.reset()
    outputs["adapter_cache"] = None
    outputs["encoder_cache"] = None
    outputs["stat"] = "dialog_ss"
    outputs = pipeline.speech_dialogue(None, **outputs)
    while outputs["stat"] == "dialog_cs" and \
            len(outputs["past_tokens"]) <= max_tokens:
        outputs = pipeline.speech_dialogue_segment(outputs, n_steps=16)
    tok = pipeline.core.tokenizer
    return tok.decode([t for t in outputs["past_tokens"] if t != tok.eod_id])


def batched_transcribe(pipeline, cfg, wavs, max_tokens: int,
                       role: str = "Transcribe the user's speech exactly."):
    """The batched twin of `transcribe`: B utterances share every device
    step (the role prefill, the chunked listen with per-row validity, one
    prefill + generate whose finished rows stop growing). Utterances are
    zero-padded to the group's largest chunk count, and a row whose
    utterance ended leaves its caches untouched (`active`), so its context
    does not depend on its batch partners. Decoding is greedy (top_k=1), so
    rows are independent of the batch's composition."""
    from ..frontend.chunker import OfflineChunker
    from ..models import audio_llm, qwen2

    core = pipeline.core
    acfg = cfg.audio_llm
    dev = core.device
    B = len(wavs)
    sampling = dataclasses.replace(cfg.sampling, top_k=1, top_p=1.0)
    ids = core._ids(core.chat.role_prompt_ids(role))[None].expand(B, -1)
    kv = qwen2.init_cache(acfg.llm, B, dtype=core.user_prefix_embeds.dtype,
                          device=dev)
    (eu, au), (es, as_) = core.audio_state(B), core.audio_state(B)
    with torch.no_grad():
        kv = audio_llm.prefill_tokens(core.params, acfg, ids, kv)
    caches = audio_llm.SessionCaches(eu, au, es, as_, kv)

    chunkers = [OfflineChunker(cfg.chunker) for _ in range(B)]
    chunk = chunkers[0].get_chunk_size()
    row_chunks = [int(math.ceil(len(w) / chunk)) for w in wavs]
    n_chunks = max(row_chunks)
    padded = np.zeros((B, n_chunks * chunk), np.float32)
    for b, w in enumerate(wavs):
        padded[b, : len(w)] = w
    for ci in range(n_chunks):
        feats = np.concatenate(
            [chunkers[b].process(padded[b, ci * chunk: (ci + 1) * chunk])
             for b in range(B)], axis=0)
        is_sl = torch.full((B,), ci == 0, dtype=torch.bool, device=dev)
        active = torch.tensor([ci < row_chunks[b] for b in range(B)],
                              device=dev)
        with torch.no_grad():
            audio_llm.recognize_step(core.params, acfg, "user",
                                     core.to_device(feats), is_sl,
                                     core.user_prefix_embeds, caches,
                                     active=active)

    sys_ids = core._ids(core.chat.system_prefix_ids)[None].expand(B, -1)
    eod = core.tokenizer.eod_id
    with torch.no_grad():
        toks, _, _, _ = audio_llm.prefill_and_generate(
            core.params, acfg, sys_ids, caches.kv, core.next_key(), sampling,
            n_steps=max_tokens, eod_id=eod)
    out = []
    for row in toks.cpu().tolist():
        if eod in row:
            row = row[: row.index(eod)]
        out.append(core.tokenizer.decode(row))
    return out


def build_pipeline(args):
    """(config, InferencePipeline) of the harnesses' --model_path /
    --llm_path / --quant / --preset / --seed / --device flags."""
    from ..config import flagship_system, tiny_system
    from ..pipeline import InferencePipeline

    if args.model_path:
        from ..utils.factory import load_system

        cfg, audiollm_params, _, tokenizer = load_system(
            args.model_path, args.llm_path, quantize_llm_bits=args.quant or None,
            device=args.device)
        return cfg, InferencePipeline(cfg, params=audiollm_params,
                                      tokenizer=tokenizer, seed=args.seed,
                                      device=args.device)
    cfg = tiny_system() if args.preset == "tiny" else flagship_system()
    return cfg, InferencePipeline(cfg, seed=args.seed, device=args.device)


def add_system_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="flagship", choices=["tiny", "flagship"])
    p.add_argument("--model_path", default=None,
                   help="reference checkpoint dir or port-native system dir "
                        "(enables real-weight eval)")
    p.add_argument("--llm_path", default=None)
    p.add_argument("--quant", default=0, type=int, choices=[0, 8, 4],
                   help="weight-only quantization bits for the loaded LLM")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--seed", type=int, default=0)


def load_wav(path: str) -> np.ndarray:
    """A manifest's wav as mono float at 16 kHz."""
    from ..frontend.wav import read_wav, resample

    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != 16000:
        wav = resample(wav, sr, 16000)
    return wav


def main(argv=None):
    p = argparse.ArgumentParser(description="CER/WER evaluation harness")
    add_system_args(p)
    p.add_argument("--manifest", required=True,
                   help="tsv: wav_path<TAB>transcript per line")
    p.add_argument("--char_level", action="store_true",
                   help="score CER instead of WER")
    p.add_argument("--max_utts", type=int, default=0)
    p.add_argument("--max_tokens", type=int, default=64)
    p.add_argument("--batch", type=int, default=0,
                   help="batched eval: N utterances (sorted by length) share "
                        "every device step, with greedy decoding")
    args = p.parse_args(argv)

    from ..frontend.chunker import OfflineChunker
    from ..utils.metrics import corpus_score

    cfg, pipeline = build_pipeline(args)
    chunker = OfflineChunker(cfg.chunker)

    # the manifest pass holds only (path, ref, n_frames): wavs load one at a
    # time (serial) or one group at a time (--batch)
    import wave as _wave

    utts = []
    with open(args.manifest) as f:
        for line in f:
            if not line.strip():
                continue
            path, ref = line.rstrip("\n").split("\t", 1)
            with _wave.open(path, "rb") as w:
                frames = w.getnframes()
            utts.append((path, ref, frames))
            if args.max_utts and len(utts) >= args.max_utts:
                break

    pairs = []
    if args.batch > 1:
        # sort by length so padding within a batch stays small
        order = sorted(range(len(utts)), key=lambda i: utts[i][2])
        for s in range(0, len(order), args.batch):
            group = [utts[i] for i in order[s: s + args.batch]]
            hyps = batched_transcribe(pipeline, cfg,
                                      [load_wav(p) for p, _, _ in group],
                                      args.max_tokens)
            for (_, ref, _), hyp in zip(group, hyps):
                pairs.append((ref, hyp))
                print(f"[{len(pairs)}] ref={ref[:40]!r} hyp={hyp[:40]!r}",
                      file=sys.stderr)
    else:
        for path, ref, _ in utts:
            hyp = transcribe(pipeline, chunker, load_wav(path), args.max_tokens)
            pairs.append((ref, hyp))
            print(f"[{len(pairs)}] ref={ref[:40]!r} hyp={hyp[:40]!r}",
                  file=sys.stderr)

    score = corpus_score(pairs, char_level=args.char_level)
    metric = "cer" if args.char_level else "wer"
    result = {"metric": metric, "value": round(100 * score, 2), "unit": "%",
              "n_utts": len(pairs)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
