"""Streaming speech synthesis: AR decoder -> codec, chunked with seam
splicing (counterpart of freeze_omni_tpu/tts.py; models/decoder/llm2tts.py:
17-160 of the reference).

- tokens come in `decode_segment` blocks, one per codec chunk, instead of a
  per-token host loop;
- the vocoder runs on windows padded to a multiple of 10 tokens (repeat the
  last token) and trimmed back in samples, as the JAX package does to bound
  its compiled shapes; the padding keeps the port's output identical;
- seam splicing (`find_min_seam`), the quiet-point search that joins codec
  chunks without clicks (llm2tts.py:70-112), runs on the host in numpy;
- `extract_global_tokens` turns a reference wav into the codec's global
  style tokens (a voice prompt) through the codec's encode half.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .config import TTSConfig
from .models import codec as codec_mod
from .models import speech_decoder as sd
from .utils.device import resolve_device


def find_min_seam(buffer: np.ndarray, syn: np.ndarray, N: int,
                  threshold: float):
    """Find the quietest sample in the second half of `syn` and splice there.

    buffer, syn: [1, 1, n] float arrays. Returns (new_buffer, emitted|None),
    the llm2TTS.find_min_sum_index semantics (llm2tts.py:70-112)."""
    arr = syn[0, 0]
    L = arr.shape[0]
    mid = L // 2
    window_sums = np.convolve(np.abs(arr), np.ones(N), mode="valid")
    start = mid - (N // 2)
    seg = window_sums[start:]
    min_index = int(np.argmin(seg))
    min_sum = float(seg[min_index])

    w_start = max(0, min_index + start)
    w_end = min(L, min_index + N + start)
    cut = int(np.argmin(np.abs(arr[w_start:w_end]))) + w_start

    if min_sum / N < threshold:
        emitted = np.concatenate([buffer, syn[:, :, :cut]], axis=-1)
        return syn[:, :, cut:].copy(), emitted
    return np.concatenate([buffer, syn], axis=-1), None


def bucket_pad(x, bucket: int, device):
    """Pad [B, T, D] frames to a multiple of `bucket` along T; returns
    (f32 tensor on `device`, [B, Tb] bool validity mask)."""
    x = np.asarray(x, np.float32)
    t = x.shape[1]
    tb = ((t + bucket - 1) // bucket) * bucket
    mask = np.zeros((x.shape[0], tb), bool)
    mask[:, :t] = True
    if tb != t:
        x = np.concatenate(
            [x, np.zeros((x.shape[0], tb - t, x.shape[2]), x.dtype)], 1)
    return torch.from_numpy(x).to(device), torch.from_numpy(mask).to(device)


def preamble(dparams, dcfg, hidden, h_mask, prefix=None, p_mask=None
             ) -> sd.DecoderCache:
    """pre-NN + prefix-KV + [bos, hidden] prefill into a fresh decoder cache
    of dcfg.max_kv_len slots (masked, bucket-padded blocks)."""
    B = hidden.shape[0]
    dev = hidden.device
    pre = sd.pre_nn(dparams, dcfg, hidden, h_mask)
    bos = sd.embedding(dparams["embedding"],
                       torch.full((B, 1), dcfg.bos_id, dtype=torch.long, device=dev))
    block = torch.cat([bos, pre], dim=1)
    b_mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), h_mask],
                       dim=1)
    cache = sd.init_cache(dcfg, B, device=dev)
    if prefix is not None and dcfg.use_prefix_kv:
        cache = sd.prefix_prefill(dparams, dcfg, prefix, p_mask, cache)
    _, cache = sd.prefill(dparams, dcfg, block, b_mask, cache)
    return cache


def vocode(codec_params, ccfg, global_tokens: torch.Tensor,
           windows) -> list:
    """Token windows (1-D int arrays) -> [1, 1, samples] float numpy each.
    Windows are padded to a multiple of 10 tokens with their last token and
    vocoded together per padded length; each output is trimmed back to its
    window's share of samples."""
    out = [None] * len(windows)
    groups = {}
    for i, win in enumerate(windows):
        groups.setdefault(((win.shape[0] + 9) // 10) * 10, []).append(i)
    dev = global_tokens.device
    for n_pad, members in groups.items():
        codes = np.zeros((len(members), n_pad), np.int64)
        for j, i in enumerate(members):
            codes[j, : windows[i].shape[0]] = windows[i]
            codes[j, windows[i].shape[0]:] = windows[i][-1]
        gt = global_tokens.expand(len(members), *global_tokens.shape[1:])
        with torch.no_grad():
            wav = codec_mod.decode(codec_params, ccfg,
                                   torch.from_numpy(codes[:, :, None]).to(dev), gt)
        wav = wav.float().cpu().numpy()
        for j, i in enumerate(members):
            keep = int(round(wav.shape[-1] * (windows[i].shape[0] / n_pad)))
            out[i] = wav[j:j + 1, :, :keep]
    return out


class StreamingTTS:
    """hidden states + (optional) prefix -> streaming 24 kHz PCM segments."""

    BUCKET = 32  # hidden/prefix frames are padded to multiples of this

    def __init__(self, params: dict, cfg: TTSConfig, seed: int = 0, device=None):
        """params: {'decoder': speech-decoder params, 'codec': codec params}
        on `device` (None: the card)."""
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.set_global_tokens(cfg.codec.global_tokens)

    def set_global_tokens(self, tokens) -> None:
        """Switch the synthesis voice: tokens = [G] global-style-token ids
        (TiCodec GST). Takes effect on the next chunk."""
        self._global_tokens = torch.as_tensor(
            np.asarray(tokens, np.int64).reshape(1, 1, -1), device=self.device)

    def run(self, hidden, prefix=None, top_k: Optional[int] = None,
            codec_chunk_size: Optional[int] = None,
            codec_padding_size: Optional[int] = None) -> Iterator[np.ndarray]:
        """hidden: [1, T, idim] text-embedding frames; prefix: [1, P, idim]
        LLM hidden-state frames or None. Yields [1, 1, n] PCM segments
        (llm2TTS.run, llm2tts.py:114-160). The sentence ends at eos, at
        cfg.max_tokens, or when the decoder cache is full; one whose
        preamble fills the cache raises ValueError before any device work."""
        cfg = self.cfg
        dcfg = cfg.decoder
        top_k = top_k if top_k is not None else cfg.top_k
        chunk = codec_chunk_size or cfg.codec_chunk_size
        padding = codec_padding_size or cfg.codec_padding_size
        up = cfg.codec.upsample_rate

        # the preamble writes bos + the hidden frames + the prefix (when the
        # decoder keeps prefix KV) into a cache of max_kv_len slots, the last
        # of them scratch; each codec token takes one more slot, so the
        # sentence ends at the cache as at its token budget (BatchedTTS's
        # rule): a write past the cache would fault on the card
        used = 1 + np.shape(hidden)[1] + (
            np.shape(prefix)[1] if prefix is not None and dcfg.use_prefix_kv else 0)
        limit = min(cfg.max_tokens, dcfg.max_kv_len - 1 - used)
        if limit < 1:
            raise ValueError(f"sentence needs {used} decoder KV slots before its "
                             f"first codec token; the cache holds {dcfg.max_kv_len}")
        with torch.no_grad():
            hidden, h_mask = bucket_pad(hidden, self.BUCKET, self.device)
            if prefix is not None and dcfg.use_prefix_kv:
                prefix, p_mask = bucket_pad(prefix, self.BUCKET, self.device)
                cache = preamble(self.params["decoder"], dcfg, hidden, h_mask,
                                 prefix, p_mask)
            else:
                cache = preamble(self.params["decoder"], dcfg, hidden, h_mask)
        state = sd.init_decode_state(dcfg, cache, max(cfg.penalty_window_size, 1))
        token_buf = np.zeros((0,), np.int64)
        pcm_buffer = np.zeros((1, 1, 0), np.float32)
        left, right = 0, padding
        done = False
        total = 0

        while not done and total < limit:
            n_steps = min(left + chunk + right - token_buf.shape[0],
                          limit - total)
            with torch.no_grad():
                toks, state = sd.decode_segment(
                    self.params["decoder"], dcfg, state, self.gen, n_steps=n_steps,
                    top_k=top_k, penalty_window=cfg.penalty_window_size,
                    penalty=cfg.penalty)
            toks = toks[0].cpu().numpy().astype(np.int64)
            total += n_steps
            # any special id (>= codec_vocab) ends the sentence, as in
            # fastpath.first_response: the codec has no embedding for one
            eos_pos = np.where(toks >= dcfg.codec_vocab)[0]
            if eos_pos.size:
                toks = toks[: eos_pos[0]]
                done = True
            token_buf = np.concatenate([token_buf, toks])

            if not done and token_buf.shape[0] == left + chunk + right:
                syn = vocode(self.params["codec"], cfg.codec,
                             self._global_tokens, [token_buf])[0]
                syn = syn[:, :, left * up: syn.shape[-1] - right * up]
                left = padding
                token_buf = token_buf[-(left + right):]
                pcm_buffer, emitted = find_min_seam(pcm_buffer, syn,
                                                    cfg.seam_window,
                                                    cfg.seam_threshold)
                if emitted is not None:
                    yield emitted

        if token_buf.shape[0] > 0:
            syn = vocode(self.params["codec"], cfg.codec, self._global_tokens,
                         [token_buf])[0]
            yield np.concatenate([pcm_buffer, syn[:, :, left * up:]], axis=-1)


def codec_input(ccfg, wav: np.ndarray, sr: int) -> np.ndarray:
    """A mono wav as the codec encoder takes it: resampled to the codec's
    rate and zero-padded to whole frames (the conv stack downsamples by
    upsample_rate), f32 [T]."""
    from .frontend.wav import resample

    wav = np.asarray(wav, np.float32).reshape(-1)
    if sr != ccfg.sample_rate:
        wav = resample(wav, sr, ccfg.sample_rate)
    up = ccfg.upsample_rate
    n = -(-max(wav.shape[0], up) // up) * up
    return np.pad(wav, (0, n - wav.shape[0]))


def extract_global_tokens(codec_params: dict, ccfg, wav: np.ndarray,
                          sr: int) -> tuple:
    """Voice prompt: TiCodec global-style tokens of a reference wav.

    The codec's mid-depth global branch summarizes timbre into GST ids
    (models.py:475-514, 617-637); synthesizing with them transfers the
    reference speaker's style. Needs codec params with the encoder branch
    (codec.init_params(..., with_encoder=True) or utils/checkpoint
    convert_codec(with_encoder=True)); runs on the params' device. Returns a
    tuple of ints for CodecConfig.global_tokens or
    StreamingTTS.set_global_tokens."""
    if "encoder" not in codec_params:
        raise ValueError(
            "codec params lack the encoder branch; build them with "
            "with_encoder=True to use a voice prompt")
    wav = codec_input(ccfg, wav, sr)
    dev = codec_params["encoder"]["conv_pre"]["w"].device
    with torch.no_grad():
        _, gst = codec_mod.encode(codec_params, ccfg,
                                  torch.from_numpy(wav[None, None, :]).to(dev))
    return tuple(int(t) for t in gst.cpu().numpy().ravel())
