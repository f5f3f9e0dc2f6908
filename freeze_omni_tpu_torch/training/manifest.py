"""Real-data training input: wav+transcript manifests -> static-shape batches
(counterpart of freeze_omni_tpu/training/manifest.py; the same batches for
the same manifest, tokenizer and seed).

Manifests are "path<TAB>transcript" lines, the format bin/asr_eval.py reads.
They feed the curriculum's ASR stages (train_step: 'ctc', 'align',
'prompt'):

- Length buckets: each batch is padded to one of a fixed set of
  (audio-frames, text-tokens) shapes, so a step sees at most
  |frame_buckets| x |text_buckets| distinct shapes.
- Silence padding in sample space: waveforms are zero-padded before the
  fbank, so padded frames are the fbank of silence (real audio, as
  `asr_align_loss`'s full-valid audio expects); the CTC stage also gets the
  true frame counts (`fbank_lens`), which mask padding out of its loss.
- `prefetch` runs the loader on a background thread with a bounded queue,
  so wav reading and the fbank overlap the device's steps.

Featurization is serving's: read_wav -> resample to 16 kHz -> fbank_ref on
int16-scaled samples (the chunkers' scaling), CMVN left to the encoder's own
cmvn params.
"""

from __future__ import annotations

import queue
import sys
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import AudioLLMConfig, FbankConfig
from ..frontend.fbank import fbank_ref, num_frames
from ..frontend.wav import read_wav, resample

ASR_STAGES = ("ctc", "align", "prompt")


def read_manifest(path: str) -> List[Tuple[str, str]]:
    """Parse "wav_path<TAB>transcript" lines (bin/asr_eval.py format).
    Blank lines and lines starting with '#' are skipped."""
    out: List[Tuple[str, str]] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            if "\t" not in line:
                raise ValueError(f"{path}:{ln}: expected 'wav<TAB>transcript'")
            wav, text = line.split("\t", 1)
            out.append((wav, text))
    if not out:
        raise ValueError(f"{path}: empty manifest")
    return out


@dataclass(frozen=True)
class ManifestConfig:
    """Bucketing/batching knobs.

    frame_buckets: allowed padded fbank frame counts, ascending. Utterances
    longer than the largest bucket are truncated (reported once to stderr).
    text_buckets: allowed padded token counts, ascending; same truncation rule.
    """

    frame_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    text_buckets: Tuple[int, ...] = (16, 32, 64)
    shuffle: bool = True
    drop_remainder: bool = False  # False: pad short batches by repeating rows


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _samples_for_frames(cfg: FbankConfig, frames: int) -> int:
    """Smallest sample count whose fbank has exactly `frames` frames
    (snip_edges arithmetic, inverse of frontend.fbank.num_frames)."""
    return (frames - 1) * cfg.frame_shift + cfg.frame_length


class Utterance:
    """One featurized manifest row: bucket-padded fbank + token ids."""

    __slots__ = ("fbank", "n_frames", "tokens")

    def __init__(self, fbank: np.ndarray, n_frames: int, tokens: np.ndarray):
        self.fbank = fbank
        self.n_frames = n_frames
        self.tokens = tokens


def featurize(wav_path: str, text: str, tokenizer, fcfg: FbankConfig,
              mcfg: ManifestConfig) -> Utterance:
    """Load + resample one wav, silence-pad to its frame bucket, fbank it.

    Padding happens in sample space so the padded tail is fbank-of-silence
    (not fabricated zero log-mels); n_frames is the true (pre-pad) count."""
    wav, sr = read_wav(wav_path)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != fcfg.sample_rate:
        wav = resample(wav, sr, fcfg.sample_rate)
    true_frames = num_frames(fcfg, wav.shape[0])
    bucket = _bucket(max(true_frames, 1), mcfg.frame_buckets)
    if true_frames > bucket:  # over the largest bucket: truncate audio
        true_frames = bucket
    n_samp = _samples_for_frames(fcfg, bucket)
    padded = np.zeros(n_samp, np.float32)
    padded[: min(wav.shape[0], n_samp)] = wav[:n_samp]
    fb = fbank_ref(padded * 32768.0, fcfg)
    assert fb.shape[0] == bucket, (fb.shape, bucket)
    tokens = np.asarray(tokenizer.encode(text), np.int32)
    return Utterance(fb.astype(np.float32), true_frames, tokens)


def _enc_frames(n_fbank: int) -> int:
    """Conv2dSubsampling4 output length (models/encoder.py arithmetic)."""
    return ((n_fbank - 1) // 2 - 1) // 2


def _make_batch(stage: str, rows: List[Utterance], t_text: int,
                pad_token: int) -> Dict[str, np.ndarray]:
    fb = np.stack([u.fbank for u in rows])  # [B, T_bucket, n_mel]
    B = len(rows)
    toks = np.full((B, t_text), pad_token, np.int32)
    tok_lens = np.zeros((B,), np.int32)
    for i, u in enumerate(rows):
        t = u.tokens[:t_text]
        toks[i, : len(t)] = t
        tok_lens[i] = len(t)
    if stage == "ctc":
        return {
            "fbank": fb,
            "fbank_lens": np.asarray([u.n_frames for u in rows], np.int32),
            "tokens": toks,
            "token_lens": tok_lens,
        }
    # align / prompt: text CE with a mask over padded token positions
    mask = np.arange(t_text)[None, :] < tok_lens[:, None]
    return {"fbank": fb, "text_ids": toks, "text_mask": mask}


def manifest_batches(stage: str, manifest: str, tokenizer,
                     cfg: AudioLLMConfig, batch: int,
                     mcfg: ManifestConfig = ManifestConfig(),
                     epochs: int = 1, seed: int = 0,
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield static-shape batches for one ASR curriculum stage.

    Rows are grouped by (frame_bucket, text_bucket); every batch from a group
    has exactly that padded shape. Short final groups are padded by repeating
    rows (keeps shapes static; the duplicate rows are real data) unless
    mcfg.drop_remainder. CTC rows whose encoder frame count can't fit the
    target length are skipped with a warning (CTC infeasible)."""
    if stage not in ASR_STAGES:
        raise ValueError(
            f"manifest data covers the ASR stages {ASR_STAGES}; "
            f"stage {stage!r} needs duplex chunk labels (see training/data.py)")
    rows = read_manifest(manifest)
    fcfg = FbankConfig(num_mel_bins=cfg.encoder.input_dim)
    feats: List[Utterance] = []
    truncated = skipped = 0
    for wav_path, text in rows:
        u = featurize(wav_path, text, tokenizer, fcfg, mcfg)
        t_text = _bucket(max(len(u.tokens), 1), mcfg.text_buckets)
        if len(u.tokens) > t_text:
            truncated += 1
        if stage == "ctc" and _enc_frames(u.n_frames) < min(len(u.tokens),
                                                            t_text):
            skipped += 1
            continue
        feats.append(u)
    if truncated:
        print(f"manifest: {truncated} transcripts truncated to the largest "
              f"text bucket ({mcfg.text_buckets[-1]})", file=sys.stderr)
    if skipped:
        print(f"manifest: {skipped} rows skipped (audio too short for CTC "
              f"target length)", file=sys.stderr)
    if not feats:
        raise ValueError(f"{manifest}: no usable rows for stage {stage!r}")

    pad_token = getattr(tokenizer, "eod_id", 0)
    rng = np.random.RandomState(seed)
    for _ in range(epochs):
        order = rng.permutation(len(feats)) if mcfg.shuffle \
            else np.arange(len(feats))
        groups: Dict[Tuple[int, int], List[Utterance]] = {}
        for idx in order:
            u = feats[idx]
            key = (u.fbank.shape[0],
                   _bucket(max(len(u.tokens), 1), mcfg.text_buckets))
            groups.setdefault(key, []).append(u)
            g = groups[key]
            if len(g) == batch:
                yield _make_batch(stage, g, key[1], pad_token)
                groups[key] = []
        for (t_frames, t_text), g in groups.items():
            if not g or mcfg.drop_remainder:
                continue
            while len(g) < batch:  # repeat rows: static shape, real data
                g.append(g[len(g) % max(len(g), 1)])
            yield _make_batch(stage, g[:batch], t_text, pad_token)


def prefetch(it: Iterator[Dict[str, np.ndarray]], depth: int = 2
             ) -> Iterator[Dict[str, np.ndarray]]:
    """Run `it` on a daemon thread with a bounded queue: host-side loading
    (wav IO, resample, fbank) overlaps device steps. Exceptions re-raise in
    the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate to consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
