"""First response from a session's context to its first PCM (counterpart of
freeze_omni_tpu/runtime/fastpath.py).

    assistant-prefix prefill -> first text segment -> re-embed the text
    tokens -> speech-decoder pre-NN + prefix-KV + prefill -> codec-token
    decode -> vocoder -> first PCM

Everything stays on the device and nothing waits for the host until the
caller fetches the result, so first audio costs one host sync. The text is
fed to the speech decoder as generated, without the host-side
pipeline.post_process, which only normalises punctuation; later sentences
go through the standard host path.
"""

from __future__ import annotations

import torch

from ..config import AudioLLMConfig, CodecConfig, SamplingConfig, SpeechDecoderConfig
from ..models import audio_llm, qwen2
from ..models import codec as codec_mod
from ..models import speech_decoder as sd


def first_response(params, tts_params, acfg: AudioLLMConfig,
                   dcfg: SpeechDecoderConfig, ccfg: CodecConfig,
                   assistant_ids: torch.Tensor, kv: qwen2.KVCache,
                   gen: torch.Generator, sampling: SamplingConfig,
                   n_text: int, n_codec: int, top_k: int, eod_id: int,
                   global_tokens: torch.Tensor, penalty_window: int = 10,
                   penalty: float = 1.1):
    """Returns (pcm [B, 1, samples], text_tokens [B, n_text+1], text_done
    [B], codec_tokens [B, n_codec], n_valid_codec [B], kv). B > 1 batches
    concurrently speaking sessions (assistant_ids [B, T], kv batch B, updated
    in place, global_tokens [B, 1, G]). The PCM length is fixed; callers trim
    it on the host to n_valid_codec (less the look-ahead padding when no eos
    fired), the reference's eos stop and right-padding trim
    (llm2tts.py:140-160). penalty_window/penalty: the codec decode's
    repetition penalty when window > 0 (decoder.py:349-351). Text and codec
    tokens are drawn from `gen` in that order."""
    B = assistant_ids.shape[0]
    dev = assistant_ids.device

    # 1) text: assistant-prefix prefill + first segment
    toks, hiddens, done, kv = audio_llm.prefill_and_generate(
        params, acfg, assistant_ids, kv, gen, sampling, n_steps=n_text,
        eod_id=eod_id)

    # 2) re-embed the generated tokens; fold the LLM-width frames to the
    #    decoder idim (bin/inference.py:86-90 reshape semantics)
    emb = qwen2.embed_tokens(params["llm"], toks.long()).float()
    emb = emb.reshape(B, -1, dcfg.idim)
    prefix = hiddens.float().reshape(B, -1, dcfg.idim)

    # 3) speech decoder preamble (pre-NN + prefix-KV + [bos, hidden] prefill)
    dparams = tts_params["decoder"]
    pre = sd.pre_nn(dparams, dcfg, emb)
    bos = sd.embedding(dparams["embedding"],
                       torch.full((B, 1), dcfg.bos_id, dtype=torch.long, device=dev))
    block = torch.cat([bos, pre], dim=1)
    cache = sd.init_cache(dcfg, B, device=dev)
    if dcfg.use_prefix_kv:
        cache = sd.prefix_prefill(dparams, dcfg, prefix,
                                  torch.ones(prefix.shape[:2], dtype=torch.bool,
                                             device=dev), cache)
    _, cache = sd.prefill(dparams, dcfg, block,
                          torch.ones(block.shape[:2], dtype=torch.bool, device=dev),
                          cache)

    # 4) codec-token decode + vocoder
    state = sd.init_decode_state(dcfg, cache, max(penalty_window, 1))
    codec_toks, _ = sd.decode_segment(dparams, dcfg, state, gen, n_steps=n_codec,
                                      top_k=top_k, penalty_window=penalty_window,
                                      penalty=penalty)
    # tokens from the first eos/pad on are invalid: count the valid prefix
    # and repeat the last valid token through the tail, so the vocoder's
    # receptive field near the cut sees speech, not clipped specials
    invalid = codec_toks >= dcfg.codec_vocab
    n_valid = torch.where(invalid.any(dim=1), invalid.int().argmax(dim=1),
                          torch.full((B,), n_codec, device=dev)).to(torch.int32)
    pos = torch.arange(n_codec, device=dev)[None, :]
    last_valid = torch.clamp(n_valid.long() - 1, min=0)[:, None]
    fill = torch.gather(codec_toks, 1, last_valid)
    codes = torch.where(pos < n_valid[:, None], codec_toks, fill)
    codes = torch.clamp(codes, 0, dcfg.codec_vocab - 1)[:, :, None]
    pcm = codec_mod.decode(tts_params["codec"], ccfg, codes, global_tokens)
    return pcm, toks, done, codec_toks, n_valid, kv
