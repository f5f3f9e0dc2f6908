"""Output-speech quality evaluation: CER of synthesized speech through ASR
(counterpart of freeze_omni_tpu/bin/out_cer_eval.py).

Harness for the reference's output-speech CER table (speech decoder +
pre-network CER at top-k 1..5, README.md:54-58): each manifest sentence is
synthesized by the AR speech decoder and the TiCodec vocoder conditioned on
the LLM's teacher-forced hidden states over that text (the decoder's
training-time conditioning, models/decoder/decoder.py:190-292), transcribed
back through the streaming ASR pipeline (bin/asr_eval.transcribe) and
scored character by character against the text. With converted reference
checkpoints this reproduces the published evaluation; with random weights
it checks the harness itself.

Manifest: one sentence per line (plain text).

Usage (the card by default; --device cpu runs the plain PyTorch versions):
  python -m freeze_omni_tpu_torch.bin.out_cer_eval \\
      --model_path freeze_omni_tpu_torch/assets/tiny_s2s \\
      --manifest freeze_omni_tpu/assets/tiny_s2s/sentences.txt --top_k 1,2 \\
      [--max_utts N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _text_hiddens(core, acfg, ids) -> np.ndarray:
    """Teacher-forced last-layer LLM hidden states over the token ids:
    [1, len(ids), D] f32, from one prefill into a fresh cache (padded to a
    multiple of 32 tokens, as the JAX harness buckets them)."""
    from ..models import qwen2
    from ..tts import bucket_pad

    with torch.no_grad():
        emb = qwen2.embed_tokens(core.params["llm"], core._ids(ids)[None])
        emb, mask = bucket_pad(emb.float().cpu().numpy(), 32, core.device)
        emb = emb.to(core.user_prefix_embeds.dtype)
        cache = qwen2.init_cache(acfg.llm, 1, max_len=int(emb.shape[1]) + 8,
                                 dtype=emb.dtype, device=core.device)
        hidden, _ = qwen2.forward(core.params["llm"], acfg.llm, emb, mask, cache)
    return hidden.float().cpu().numpy()[:, : len(ids)]


def synthesize_text(pipeline, tts, cfg, text: str, top_k: int):
    """text -> 24 kHz PCM through the sentence-to-speech glue
    (bin/inference.py:82-92): post-process, re-embed with the LLM table, the
    teacher-forced hidden states as the decoder prefix. Returns f32 PCM, or
    None for a text with no tokens."""
    from ..models import qwen2

    core = pipeline.core
    ids = core.tokenizer.encode(pipeline.post_process(text))
    if not ids:
        return None
    dec_idim = cfg.tts.decoder.idim
    with torch.no_grad():
        emb = qwen2.embed_tokens(core.params["llm"], core._ids(ids))
    emb = emb.float().cpu().numpy().reshape(-1, dec_idim)[None]
    prefix = _text_hiddens(core, cfg.audio_llm, ids).reshape(-1, dec_idim)[None]
    segs = [s[0, 0] for s in tts.run(emb, prefix=prefix, top_k=top_k)]
    return np.concatenate(segs) if segs else None


def main(argv=None):
    from .asr_eval import add_system_args

    p = argparse.ArgumentParser(description="output-speech CER harness")
    add_system_args(p)
    p.add_argument("--manifest", required=True, help="one sentence per line")
    p.add_argument("--top_k", default="1,2,3,4,5",
                   help="comma-separated decoder top-k sweep (the reference "
                        "table's 1..5 columns)")
    p.add_argument("--max_utts", type=int, default=0)
    p.add_argument("--max_tokens", type=int, default=64,
                   help="ASR generation cap per utterance")
    p.add_argument("--dump_wav_dir", default=None,
                   help="optionally save each synthesized wav here")
    args = p.parse_args(argv)

    from ..config import flagship_system, tiny_system
    from ..frontend.chunker import OfflineChunker
    from ..frontend.wav import resample, write_wav
    from ..pipeline import InferencePipeline
    from ..tts import StreamingTTS
    from ..utils.device import resolve_device
    from ..utils.metrics import corpus_score
    from .asr_eval import transcribe

    device = resolve_device(args.device)
    tts_params = tokenizer = params = None
    if args.model_path:
        from ..utils.factory import load_system

        cfg, params, tts_params, tokenizer = load_system(
            args.model_path, args.llm_path, quantize_llm_bits=args.quant or None,
            device=device)
    else:
        cfg = tiny_system() if args.preset == "tiny" else flagship_system()
    pipeline = InferencePipeline(cfg, params=params, tokenizer=tokenizer,
                                 seed=args.seed, device=device)
    if tts_params is None:
        from ..models import codec as codec_mod
        from ..models import speech_decoder as sd

        g = torch.Generator(device=device).manual_seed(args.seed + 7)
        tts_params = {"decoder": sd.init_params(cfg.tts.decoder, g, device=device),
                      "codec": codec_mod.init_params(cfg.tts.codec, g,
                                                     device=device)}
    tts = StreamingTTS(tts_params, cfg.tts, seed=args.seed, device=device)
    chunker = OfflineChunker(cfg.chunker)

    texts = []
    with open(args.manifest) as f:
        for line in f:
            if line.strip():
                texts.append(line.strip())
            if args.max_utts and len(texts) >= args.max_utts:
                break

    top_ks = [int(k) for k in str(args.top_k).split(",") if k.strip()]
    by_top_k, hyps = {}, {}
    for top_k in top_ks:
        pairs = []
        for i, text in enumerate(texts):
            pcm24 = synthesize_text(pipeline, tts, cfg, text, top_k)
            if pcm24 is None:
                continue
            if args.dump_wav_dir:
                os.makedirs(args.dump_wav_dir, exist_ok=True)
                write_wav(f"{args.dump_wav_dir}/k{top_k}_{i:04d}.wav",
                          pcm24.astype(np.float32), cfg.tts.codec.sample_rate)
            wav16 = resample(pcm24, cfg.tts.codec.sample_rate, 16000)
            hyp = transcribe(pipeline, chunker, wav16, args.max_tokens)
            pairs.append((text, hyp))
            print(f"[k={top_k} {len(pairs)}/{len(texts)}] ref={text[:40]!r} "
                  f"hyp={hyp[:40]!r}", file=sys.stderr, flush=True)
        by_top_k[top_k] = (100.0 * corpus_score(pairs, char_level=True)
                           if pairs else float("nan"))
        hyps[top_k] = [h for _, h in pairs]

    best = min((v for v in by_top_k.values() if v == v), default=float("nan"))
    print(json.dumps({"metric": "out_cer", "value": best, "unit": "%",
                      "by_top_k": {str(k): v for k, v in by_top_k.items()},
                      "n_utts": len(texts)}))
    return {"by_top_k": by_top_k, "hypotheses": hyps}


if __name__ == "__main__":
    main()
