"""Spoken question-answering evaluation: accuracy / EM / F1 over a wav
manifest (counterpart of freeze_omni_tpu/bin/qa_eval.py).

Harness for the reference's spoken-QA benchmark rows (Web Questions, LlaMA
Questions, Audio Trivia QA accuracy). Listens to each spoken question
through the streaming pipeline, generates the text answer and scores it
against the gold answers. With converted reference checkpoints this
reproduces the published evaluation; with random weights it checks the
harness itself.

Manifest: tab-separated lines "path<TAB>answer", where answer may hold
alternatives separated by "|||".

Usage (the card by default; --device cpu runs the plain PyTorch versions):
  python -m freeze_omni_tpu_torch.bin.qa_eval \\
      --model_path freeze_omni_tpu_torch/assets/tiny_s2s \\
      --manifest freeze_omni_tpu/assets/tiny_s2s/qa_dev.tsv \\
      --batch 8 --max_tokens 12 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

QA_ROLE = ("You are a helpful assistant. Answer the user's question "
           "concisely.")


def main(argv=None):
    from ..frontend.chunker import OfflineChunker
    from ..utils.metrics import qa_contains, qa_exact_match, qa_f1
    from .asr_eval import (add_system_args, batched_transcribe, build_pipeline,
                           load_wav, transcribe)

    p = argparse.ArgumentParser(description="spoken-QA evaluation harness")
    add_system_args(p)
    p.add_argument("--manifest", required=True,
                   help="tsv: wav_path<TAB>answer[ ||| alt ...] per line")
    p.add_argument("--max_utts", type=int, default=0)
    p.add_argument("--max_tokens", type=int, default=64)
    p.add_argument("--batch", type=int, default=0,
                   help="batched eval: B questions share every device step "
                        "(greedy decoding)")
    args = p.parse_args(argv)

    cfg, pipeline = build_pipeline(args)
    chunker = OfflineChunker(cfg.chunker)

    utts = []
    with open(args.manifest) as f:
        for line in f:
            if not line.strip():
                continue
            path, ans = line.rstrip("\n").split("\t", 1)
            utts.append((path, [a.strip() for a in ans.split("|||")]))
            if args.max_utts and len(utts) >= args.max_utts:
                break

    scored = []
    if args.batch > 1:
        for s in range(0, len(utts), args.batch):
            group = utts[s: s + args.batch]
            hyps = batched_transcribe(pipeline, cfg,
                                      [load_wav(p) for p, _ in group],
                                      args.max_tokens, role=QA_ROLE)
            for (_, golds), hyp in zip(group, hyps):
                scored.append((golds, hyp))
                print(f"[{len(scored)}] gold={golds[0][:40]!r} "
                      f"hyp={hyp[:40]!r}", file=sys.stderr)
    else:
        for path, golds in utts:
            hyp = transcribe(pipeline, chunker, load_wav(path), args.max_tokens,
                             role=QA_ROLE)
            scored.append((golds, hyp))
            print(f"[{len(scored)}] gold={golds[0][:40]!r} hyp={hyp[:40]!r}",
                  file=sys.stderr)

    n = max(1, len(scored))
    acc = sum(qa_contains(g, h) for g, h in scored) / n
    em = sum(qa_exact_match(g, h) for g, h in scored) / n
    f1 = sum(qa_f1(g, h) for g, h in scored) / n
    result = {"metric": "qa_accuracy", "value": round(100 * acc, 2),
              "unit": "%", "n_utts": len(scored),
              "detail": {"exact_match": round(100 * em, 2),
                         "f1": round(100 * f1, 2)}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
