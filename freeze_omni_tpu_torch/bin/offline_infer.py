"""Offline single-turn speech-to-speech CLI: wav in -> wav out (counterpart of
freeze_omni_tpu/bin/offline_infer.py).

Parity with bin/inference.py:94-187 of the reference (upstream semantics,
with the text generation loop the fork removed): listen chunk by chunk,
force 'dialog_ss', generate text in segments cut at sentence boundaries,
synthesize each sentence through the AR speech decoder and the codec, and
write 24 kHz audio. The stage machine is `pipeline.InferencePipeline`.

Usage (the card by default; --device cpu runs the plain PyTorch versions):
  python -m freeze_omni_tpu_torch.bin.offline_infer --preset tiny \\
      --input_wav in.wav --output_wav out.wav \\
      [--model_path CKPT --llm_path LLM] [--device cpu]

`--model_path` takes a reference checkpoint dir (with `--llm_path`) or a
port-native system dir. `--voice_wav` speaks in the voice of a reference
wav: the codec's global style tokens of it (the codec's encode half; seeded
random codec weights are then drawn with the encoder branch).
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from ..config import SystemConfig, flagship_system, tiny_system
from ..frontend.chunker import OfflineChunker
from ..frontend.wav import read_wav, resample, write_wav
from ..models import qwen2
from ..pipeline import InferencePipeline
from ..tts import StreamingTTS
from ..utils.logging import span, span_report

SENTENCE_SUFFIXES = ("。", "：", "？", "！", ".", "?", "!", "\n")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="freeze-omni offline inference (PyTorch)")
    p.add_argument("--preset", default="flagship", choices=["tiny", "flagship"])
    p.add_argument("--model_path", default=None,
                   help="reference checkpoint dir or port-native system dir")
    p.add_argument("--llm_path", default=None, help="HF LLM dir")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--input_wav", required=True)
    p.add_argument("--output_wav", required=True)
    p.add_argument("--max_tokens", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--voice_wav", default=None,
                   help="voice prompt: reference wav whose TiCodec global "
                        "style tokens condition the synthesized speech "
                        "(needs codec params with the encoder branch)")
    return p.parse_args(argv)


def synthesize_sentence(pipeline: InferencePipeline, tts: StreamingTTS,
                        hidden_states, text: str, wav_out: list,
                        decoder_topk: int = 2):
    """The sentence-to-speech glue (bin/inference.py:82-92): post-process
    the text, re-embed it with the LLM embedding table, view both the
    embeddings and the collected hidden states as idim-wide frames, and
    stream PCM."""
    core = pipeline.core
    dec_idim = tts.cfg.decoder.idim
    text_p = pipeline.post_process(text)
    ids = core.tokenizer.encode(text_p)
    if not ids:
        return
    with torch.no_grad():
        emb = qwen2.embed_tokens(core.params["llm"], core._ids(ids))
    emb = emb.float().cpu().numpy().reshape(-1, dec_idim)[None]
    prefix = np.concatenate(hidden_states, axis=1)  # [1, n, D]
    prefix = np.asarray(prefix, np.float32).reshape(-1, dec_idim)[None]
    for seg in tts.run(emb, prefix=prefix, top_k=decoder_topk):
        wav_out.append(seg[0, 0])


def run_inference(cfg: SystemConfig, args, pipeline=None, tts_params=None):
    """One turn: returns (the response text, 24 kHz PCM), and writes the PCM
    to args.output_wav. `pipeline` and `tts_params` (trees on the
    pipeline's device) skip the loading."""
    device = getattr(args, "device", None)
    voice_wav = getattr(args, "voice_wav", None)
    with span("init"):
        model_path = getattr(args, "model_path", None)
        if pipeline is None and model_path:
            from ..utils.factory import load_system

            cfg, audiollm_params, tts_params, tokenizer = load_system(
                model_path, args.llm_path, device=device)
            pipeline = InferencePipeline(cfg, params=audiollm_params,
                                         tokenizer=tokenizer, seed=args.seed,
                                         device=device)
        if pipeline is None:
            pipeline = InferencePipeline(cfg, seed=args.seed, device=device)
        dev = pipeline.core.device
        if tts_params is None:
            from ..models import codec as codec_mod
            from ..models import speech_decoder as sd

            g = torch.Generator(device=dev).manual_seed(args.seed + 7)
            tts_params = {"decoder": sd.init_params(cfg.tts.decoder, g, device=dev),
                          "codec": codec_mod.init_params(
                              cfg.tts.codec, g, device=dev,
                              with_encoder=bool(voice_wav))}
        tts = StreamingTTS(tts_params, cfg.tts, seed=args.seed, device=dev)
        if voice_wav:
            from ..tts import extract_global_tokens

            vwav, vsr = read_wav(voice_wav)
            if vwav.ndim > 1:
                vwav = vwav.mean(axis=1)
            gst = extract_global_tokens(tts_params["codec"], cfg.tts.codec,
                                        vwav, vsr)
            tts.set_global_tokens(gst)
            print(f"voice prompt: global tokens {gst}")
        chunker = OfflineChunker(cfg.chunker)

    with span("read_audio"):
        wav, fs = read_wav(args.input_wav)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if fs != 16000:
            wav = resample(wav, fs, 16000)

    # Stage 0: system-role prefill
    with span("pre"):
        outputs = pipeline.speech_dialogue(
            None, stat="pre", role="You are a helpful assistant.")

    # Stage 1: listen
    chunk = chunker.get_chunk_size()
    n = int(math.ceil(len(wav) / chunk)) * chunk
    padded = np.zeros(n, np.float32)
    padded[: len(wav)] = wav
    with span("listen"):
        for i in range(0, n, chunk):
            fbank = chunker.process(padded[i : i + chunk])
            outputs = pipeline.speech_dialogue(fbank, **outputs)
            outputs["stat"] = "dialog_cl"
    chunker.reset()

    # Stage 2: reset the audio caches, force speaking
    outputs["adapter_cache"] = None
    outputs["encoder_cache"] = None
    outputs["stat"] = "dialog_ss"

    # Stage 3/4: text in segments on the device, speech per sentence
    wav_segments: list = []
    with span("generate"):
        outputs = pipeline.speech_dialogue(None, **outputs)  # 'dialog_ss'
        tok = pipeline.core.tokenizer
        cur_hidden = [outputs["hidden_state"]]
        cur_tokens = list(outputs["past_tokens"])
        whole_tokens = list(outputs["past_tokens"])

        def flush():
            nonlocal cur_hidden, cur_tokens
            text = tok.decode([t for t in cur_tokens if t != tok.eod_id])
            if text.strip() and cur_hidden:
                with span("synthesize"):
                    synthesize_sentence(pipeline, tts, cur_hidden, text,
                                        wav_segments)
            cur_hidden, cur_tokens = [], []

        while outputs["stat"] == "dialog_cs" and \
                len(outputs["past_tokens"]) <= args.max_tokens:
            outputs = pipeline.speech_dialogue_segment(outputs, n_steps=16)
            seg_toks = outputs["segment_tokens"]
            seg_hid = outputs["segment_hiddens"]  # [1, k, D]
            whole_tokens += seg_toks
            # host-side sentence-boundary scan over the segment
            # (bin/inference.py:160-174 semantics, token-aligned)
            for j, t in enumerate(seg_toks):
                cur_tokens.append(t)
                cur_hidden.append(seg_hid[:, j : j + 1])
                piece = tok.decode([t]) if t != tok.eod_id else ""
                if piece.endswith(SENTENCE_SUFFIXES):
                    prev = tok.decode(cur_tokens[:-1])
                    if not (piece.endswith(".") and prev[-1:].isdigit()):
                        flush()
        flush()
        whole_text = tok.decode([t for t in whole_tokens if t != tok.eod_id])

    with span("write_audio"):
        out = (np.concatenate(wav_segments) if wav_segments
               else np.zeros(1, np.float32))
        write_wav(args.output_wav, out, cfg.tts.codec.sample_rate)

    print("text:", whole_text)
    print(span_report())
    return whole_text, out


def main(argv=None):
    args = get_args(argv)
    cfg = tiny_system() if args.preset == "tiny" else flagship_system()
    cfg = dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, top_k=args.top_k,
                                          top_p=args.top_p,
                                          temperature=args.temperature))
    run_inference(cfg, args)


if __name__ == "__main__":
    main()
