"""Training: the Freeze-Omni curriculum's losses and steps (counterpart of
freeze_omni_tpu/training/train_step.py).

- `encoder_ctc_loss`: input-side stage 1, encoder ASR pretraining with a
  CTC head (no LLM);
- `asr_align_loss`: input-side stages 2/3, fbank -> encoder -> adapter ->
  frozen LLM over [prompt?; audio; transcript] with text CE; which modules
  train is decided by membership in `trainable` (stage 2: the adapter and
  encoder, stage 3: `prompt_embeddings` only);
- `audio_llm_loss`: the duplex stage, the 4-class state-head CE per LLM
  chunk position;
- `lora_lm_loss`: next-token CE through the frozen LLM with only a LoRA
  adapter trainable;
- `speech_decoder_loss`: the output side, the speech decoder's
  teacher-forced CE over [hidden; sos, y];
- `stage_step`: one AdamW step (`optim.adamw`, optax's settings) on the
  trainable tree of one stage ('all' is the JAX `train_step`'s combined
  objective); the frozen LLM gets no gradient.

Data parallelism: a jit over a data-sharded batch computes the loss of the
GLOBAL batch, so its gradient is that of the global mean, which the sum of
the ranks' local means is not (a rank whose rows hold more valid tokens
weighs them otherwise). Every rank builds the same global batch, so
`loss_denominators` takes each mean's denominator from it on the host; a
rank's loss is its rows' numerator over the global denominator, and
`stage_step(group=)` sums the ranks' gradients (and losses) with one
all_reduce over a flat buffer before the AdamW step.
`broadcast_train_state` makes the replicas bit-identical after init or
resume.

The frozen LLM runs `qwen2.train_forward`, the causal forward the JAX losses
get from `qwen2.forward` over a fresh cache of T + 1 slots, without the
in-place cache of the serving path. A TrainState is mutable here: the step
updates its leaves in place and returns it.

CTC: `torch.nn.functional.ctc_loss` takes log-probabilities and lengths
where `optax.ctc_loss` takes logits and padding masks; the two agree on
batches where every target fits its frames. On an infeasible row (more
target tokens than a CTC path can place) optax returns a finite loss
(~1e5, its log-epsilon) and torch returns inf; that row is not masked here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioLLMConfig, SpeechDecoderConfig
from ..models import adapter as adapter_mod
from ..models import encoder as encoder_mod
from ..models import qwen2
from ..models import speech_decoder as sd
from ..models.layers import (NEG_INF, embedding, layer_params, linear,
                             linear_init, rms_norm, rotary_embed)
from ..parallel import collectives
from . import optim

STAGES = ("ctc", "align", "prompt", "state", "decoder", "lora", "all")


def init_ctc_head(gen: torch.Generator, cfg: AudioLLMConfig, vocab: int,
                  device=None) -> dict:
    """CTC projection for input-side stage 1: encoder dim -> vocab + 1 (the
    extra class is the blank, id = vocab)."""
    return linear_init(gen, cfg.encoder.output_dim, vocab + 1,
                       dtype=torch.float32, device=device)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 denom: Optional[float] = None) -> torch.Tensor:
    """sum(x * mask) over the mask's count (at least 1), or over `denom`
    where the caller gives the global batch's count."""
    m = mask.to(x.dtype)
    return (x * m).sum() / (torch.clamp(m.sum(), min=1) if denom is None else denom)


def encoder_ctc_loss(trainable, cfg: AudioLLMConfig, fbank: torch.Tensor,
                     fbank_lens: torch.Tensor, tokens: torch.Tensor,
                     token_lens: torch.Tensor,
                     rows: Optional[float] = None) -> torch.Tensor:
    """Mean per-utterance CTC negative log-likelihood, each divided by its
    target length (summed over `rows` utterances where given: the global
    batch's). trainable: {'encoder_user', 'ctc_head'}; fbank [B, T, 80]
    with `fbank_lens` valid frames a row; tokens [B, N] (ids < vocab) with
    `token_lens`."""
    enc = encoder_mod.forward(trainable["encoder_user"], cfg.encoder, fbank)
    logits = linear(trainable["ctc_head"], enc.float())
    blank = logits.shape[-1] - 1
    T = enc.shape[1]
    t_enc = ((fbank_lens.long() - 1) // 2 - 1) // 2   # Conv2dSubsampling4
    logp = torch.log_softmax(logits, dim=-1).transpose(0, 1)   # [T, B, C]
    per_utt = F.ctc_loss(logp, tokens.long(), torch.clamp(t_enc, 0, T),
                         token_lens.long(), blank=blank, reduction="none")
    per_utt = per_utt / torch.clamp(token_lens.float(), min=1.0)
    return torch.mean(per_utt) if rows is None else per_utt.sum() / rows


def asr_align_loss(trainable, frozen, cfg: AudioLLMConfig, fbank: torch.Tensor,
                   text_ids: torch.Tensor, text_mask: torch.Tensor,
                   denom: Optional[float] = None) -> torch.Tensor:
    """Text CE through the frozen LLM on the transcript positions of
    [prompt_embeddings?; audio embeds; transcript embeds] (each token
    predicted from the position before it). A module in `trainable` trains;
    otherwise its `frozen` copy is used. Audio rows are full-valid; text_mask
    [B, Tt] masks transcript padding."""
    def pick(name):
        return trainable[name] if name in trainable else frozen[name]

    enc = encoder_mod.forward(pick("encoder_user"), cfg.encoder, fbank)
    audio = adapter_mod.forward(pick("adapter_user"), cfg.adapter, enc)
    B = audio.shape[0]
    parts = [audio]
    if "prompt_embeddings" in trainable or "prompt_embeddings" in frozen:
        pe = pick("prompt_embeddings")
        parts.insert(0, pe[None].expand(B, *pe.shape).to(audio.dtype))
    text_emb = qwen2.embed_tokens(frozen["llm"], text_ids.long()).to(audio.dtype)
    seq = torch.cat(parts + [text_emb], dim=1)
    S = seq.shape[1]
    hidden = qwen2.train_forward(frozen["llm"], cfg.llm, seq)
    Tt = text_ids.shape[1]
    pred = hidden[:, S - Tt - 1: S - 1].float()
    logits = qwen2.logits(frozen["llm"], cfg.llm, pred)
    return _masked_mean(_nll(logits, text_ids), text_mask, denom)


def audio_llm_loss(trainable, frozen, cfg: AudioLLMConfig, fbank: torch.Tensor,
                   labels: torch.Tensor, label_mask: torch.Tensor,
                   denom: Optional[float] = None) -> torch.Tensor:
    """State-head CE per LLM chunk position. trainable: {'encoder_user',
    'adapter_user', 'predictor'}; frozen: {'llm'}. fbank [B, T_f, 80];
    labels [B, Tc]; label_mask [B, Tc]."""
    enc = encoder_mod.forward(trainable["encoder_user"], cfg.encoder, fbank)
    emb = adapter_mod.forward(trainable["adapter_user"], cfg.adapter, enc)
    hidden = qwen2.train_forward(frozen["llm"], cfg.llm, emb)
    logits = linear(trainable["predictor"], hidden.float())
    logits = logits[:, :labels.shape[1]]
    return _masked_mean(_nll(logits, labels), label_mask, denom)


def _pair_mask(text_mask):
    """The next-token positions whose token and predecessor are both valid."""
    return text_mask[:, 1:] & text_mask[:, :-1]


def lora_lm_loss(trainable, frozen, cfg: AudioLLMConfig, text_ids: torch.Tensor,
                 text_mask: torch.Tensor, lora_scale: float = 1.0,
                 denom: Optional[float] = None) -> torch.Tensor:
    """Next-token CE through the frozen LLM with only the adapter trainable.
    trainable: {'lora': {proj: {'a', 'b'}}}; frozen: {'llm'}. Token t is
    predicted from position t - 1; the base weights, embeddings and lm_head
    get no gradient."""
    emb = qwen2.embed_tokens(frozen["llm"], text_ids.long())
    hidden = qwen2.train_forward(frozen["llm"], cfg.llm, emb,
                                 lora=trainable["lora"], lora_scale=lora_scale)
    logits = qwen2.logits(frozen["llm"], cfg.llm, hidden[:, :-1].float())
    return _masked_mean(_nll(logits, text_ids[:, 1:]), _pair_mask(text_mask),
                        denom)


def speech_decoder_loss(params, cfg: SpeechDecoderConfig, hidden: torch.Tensor,
                        hidden_lens: torch.Tensor, y: torch.Tensor,
                        y_lens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced CE (decoder.py:190-292 of the reference): input
    [pre_nn(hidden) with bos; sos, y], target [y, eos]; the hidden block
    sees itself bidirectionally, the token block is causal and sees the
    valid hidden block. Sum over tokens."""
    B, Th, D = hidden.shape
    Ty = y.shape[1]
    dev = hidden.device
    h_mask = torch.arange(Th, device=dev)[None, :] < hidden_lens[:, None]

    pre = sd.pre_nn(params, cfg, hidden, h_mask)
    bos = embedding(params["embedding"],
                    torch.full((B, 1), cfg.bos_id, dtype=torch.long, device=dev))
    h_block = torch.cat([bos, pre], dim=1)                       # [B, Th+1, D]
    h_blk_mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                            h_mask], dim=1)
    Lh = Th + 1

    sos = torch.full((B, 1), cfg.sos_id, dtype=torch.long, device=dev)
    x_emb = embedding(params["embedding"], torch.cat([sos, y.long()], dim=1))
    t_mask = torch.arange(Ty + 1, device=dev)[None, :] <= y_lens[:, None]

    S = Lh + Ty + 1
    x = torch.cat([h_block, x_emb], dim=1)                       # [B, S, D]
    valid = torch.cat([h_blk_mask, t_mask], dim=1)
    idx = torch.arange(S, device=dev)
    row, col = idx[:, None], idx[None, :]
    base = (col < Lh) | ((col >= Lh) & (col <= row))
    vis = base[None] & valid[:, None, :] & valid[:, :, None]     # [B, S, S]

    H, dk = cfg.num_heads, cfg.head_dim
    cos, sin = rotary_embed(idx, dk, cfg.rope_theta)

    def rot(t):
        d2 = t.shape[-1] // 2
        r = torch.cat([-t[..., d2:], t[..., :d2]], dim=-1)
        return t * cos[None, :, None, :] + r * sin[None, :, None, :]

    for i in range(params["layers"]["q"]["w"].shape[0]):
        lp = layer_params(params["layers"], i)
        h = rms_norm(lp["ln1"], x, cfg.rms_eps)
        q = rot(linear(lp["q"], h).reshape(B, S, H, dk))
        k = rot(linear(lp["k"], h).reshape(B, S, H, dk))
        v = linear(lp["v"], h).reshape(B, S, H, dk)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dk)
        scores = torch.where(vis[:, None], scores, torch.full_like(scores, NEG_INF))
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, S, H * dk)
        x = x + linear(lp["o"], o)
        h2 = rms_norm(lp["ln2"], x, cfg.rms_eps)
        x = x + linear(lp["down"], F.silu(linear(lp["gate"], h2)) * linear(lp["up"], h2))
    x = rms_norm(params["final_norm"], x, cfg.rms_eps)
    logits = linear(params["out"], x[:, Lh:])                    # [B, Ty+1, V]

    tgt = torch.cat([y.long(), torch.full((B, 1), cfg.pad_id, dtype=torch.long,
                                          device=dev)], dim=1)
    eos_pos = torch.arange(Ty + 1, device=dev)[None, :] == y_lens[:, None]
    tgt = torch.where(eos_pos, torch.full_like(tgt, cfg.eos_id), tgt)
    nll = _nll(logits.float(), tgt)
    return (nll * t_mask.to(nll.dtype)).sum()


@dataclass
class TrainState:
    """The trainable tree (autograd leaves), its AdamW and the step count.
    `stage_step` updates all three in place."""

    trainable: dict
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(trainable: dict, lr: float = 1e-4,
                     weight_decay: float = 0.01) -> TrainState:
    """Copies `trainable` into new autograd leaves under optax.adamw's
    settings (`optim.adamw`)."""
    tree = optim.trainable(trainable)
    return TrainState(tree, optim.adamw(tree, lr, weight_decay), 0)


def to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A numpy batch (training/data.py, training/manifest.py) on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def combined_loss(trainable, frozen, cfg: AudioLLMConfig,
                  dcfg: SpeechDecoderConfig, batch: dict,
                  denoms: Optional[dict] = None) -> torch.Tensor:
    """The duplex objective (the JAX `train_step`'s): state-head CE, plus
    0.1 x the speech decoder's CE per row where the batch carries codec
    targets. `denoms` as in stage_loss."""
    denoms = denoms or {}
    loss = audio_llm_loss(
        {k: trainable[k] for k in ("encoder_user", "adapter_user", "predictor")},
        frozen, cfg, batch["fbank"], batch["labels"], batch["label_mask"],
        denoms.get("mask"))
    if "dec_hidden" in batch:
        loss = loss + 0.1 * speech_decoder_loss(
            trainable["speech_decoder"], dcfg, batch["dec_hidden"],
            batch["dec_hidden_lens"], batch["dec_y"], batch["dec_y_lens"]) \
            / denoms.get("rows", batch["dec_y"].shape[0])
    return loss


def loss_denominators(stage: str, batch: Dict) -> dict:
    """The denominators of `stage`'s means over a (global) batch of numpy
    arrays or tensors: "mask", the count its masked mean divides by (at
    least 1, as _masked_mean clamps it), and "rows", the utterances its
    per-row mean divides by (ctc, decoder, and all with codec targets)."""
    def count(mask):
        return max(float(np.asarray(mask).sum()), 1.0)

    out = {}
    if stage in ("align", "prompt"):
        out["mask"] = count(batch["text_mask"])
    elif stage in ("state", "all"):
        out["mask"] = count(batch["label_mask"])
    elif stage == "lora":
        m = np.asarray(batch["text_mask"])
        out["mask"] = count(_pair_mask(m))
    if stage == "ctc":
        out["rows"] = float(len(batch["tokens"]))
    elif stage == "decoder" or (stage == "all" and "dec_y" in batch):
        out["rows"] = float(len(batch["dec_y"]))
    return out


def stage_loss(stage: str, trainable, frozen, cfg: AudioLLMConfig,
               dcfg: Optional[SpeechDecoderConfig], batch: dict,
               denoms: Optional[dict] = None) -> torch.Tensor:
    """One curriculum stage's loss. 'align' and 'prompt' share
    asr_align_loss (they differ in what sits in `trainable`); 'all' is the
    combined duplex objective. `denoms` (loss_denominators of the global
    batch) replaces the batch's own denominators: a data-parallel rank's
    loss over its rows is then its share of the global batch's loss."""
    d = denoms or {}
    if stage == "ctc":
        return encoder_ctc_loss(trainable, cfg, batch["fbank"],
                                batch["fbank_lens"], batch["tokens"],
                                batch["token_lens"], d.get("rows"))
    if stage in ("align", "prompt"):
        return asr_align_loss(trainable, frozen, cfg, batch["fbank"],
                              batch["text_ids"], batch["text_mask"], d.get("mask"))
    if stage == "state":
        return audio_llm_loss(trainable, frozen, cfg, batch["fbank"],
                              batch["labels"], batch["label_mask"], d.get("mask"))
    if stage == "decoder":
        return speech_decoder_loss(
            trainable["speech_decoder"], dcfg, batch["dec_hidden"],
            batch["dec_hidden_lens"], batch["dec_y"],
            batch["dec_y_lens"]) / d.get("rows", batch["dec_y"].shape[0])
    if stage == "lora":
        return lora_lm_loss(trainable, frozen, cfg, batch["text_ids"],
                            batch["text_mask"], denom=d.get("mask"))
    if stage == "all":
        return combined_loss(trainable, frozen, cfg, dcfg, batch, denoms)
    raise ValueError(f"unknown stage {stage!r} (expected one of {STAGES})")


def stage_step(stage: str, state: TrainState, frozen: dict,
               cfg: AudioLLMConfig, dcfg: Optional[SpeechDecoderConfig],
               batch: dict, denoms: Optional[dict] = None,
               group=None) -> Tuple[TrainState, dict]:
    """One AdamW step of one curriculum stage; returns (state, {'loss'})
    with the loss before the update. The convolutions (the encoder's
    subsampling, the adapter) run without cuDNN: on an H100 with TF32 off,
    cuDNN's backward at these shapes put the state stage's encoder
    gradients up to 1.3e-1 of a leaf's largest entry away from the CPU's,
    where PyTorch's own convolutions stay within 2.2e-6 (chip_smoke.py
    phase 14a).

    Data-parallel (`group`, a process group of more than one rank, e.g.
    torch.distributed.group.WORLD): `batch`
    is this rank's rows of the global batch and `denoms` the global batch's
    loss_denominators; the ranks' gradients and losses are summed with one
    all_reduce over a flat buffer, so every rank takes the step of the
    global batch and returns its loss. (The curriculum's optax.adamw clips
    nothing; a clip would go after the sum, on the global gradient.)"""
    params = optim.leaves(state.trainable)
    with torch.backends.cudnn.flags(enabled=False):
        loss = stage_loss(stage, state.trainable, frozen, cfg, dcfg, batch, denoms)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    loss = loss.detach()
    if group is not None and collectives.group_size(group) > 1:
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        collectives.all_reduce_(flat, group)
        grads = [f.view_as(g) for f, g in zip(
            torch.split(flat[:-1], [g.numel() for g in grads]), grads)]
        loss = flat[-1]
    optim.set_grads(state.trainable, grads)
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss}


def broadcast_train_state(state: TrainState, group) -> None:
    """Rank 0's trainable leaves and AdamW moments and step counts (where
    the optimizer holds any: after a resume) into every rank's, in place,
    with one broadcast of a flat buffer, so data-parallel replicas start
    bit-identical."""
    if collectives.group_size(group) == 1:
        return
    params = optim.leaves(state.trainable)
    tensors = [p.data for p in params]
    for p in params:
        st = state.optimizer.state.get(p)
        if st:
            tensors += [st["exp_avg"], st["exp_avg_sq"], st["step"]]
    flat = torch.cat([t.detach().reshape(-1).to(params[0].device, torch.float32)
                      for t in tensors])
    collectives.broadcast_(flat, 0, group)
    for t, f in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(f.view_as(t))
