"""Training CLI: the Freeze-Omni curriculum with checkpoint and resume
(counterpart of freeze_omni_tpu/bin/train.py).

Stages (--stage):
  ctc      input side 1: encoder ASR pretraining (CTC head, no LLM)
  align    input side 2: encoder + adapter text CE through the frozen LLM
  prompt   input side 3: prompt-embedding tuning only
  state    duplex: encoder / adapter / state-head chunk-label CE
  decoder  output side 2/3: the speech decoder's teacher-forced CE
  lora     a low-rank adapter on the frozen LLM (next-token CE); writes
           <ckpt_dir>/lora.npz, which `serve --lora` reads in both packages
  all      the combined duplex step (state [+ decoder]), the default
(Output side 1, the codec GAN, is training/codec_gan.py.)

The frozen LLM is float32, as the JAX CLI draws it, and gets no gradient;
the trainable tree takes AdamW steps (optax.adamw's settings). Data:
synthetic fixtures (training/data.py, the JAX package's draws for a seed),
or with --manifest a wav<TAB>transcript TSV for the ASR stages
(training/manifest.py). --ckpt_dir with --save_every writes `latest`
(trainable params), `opt` (AdamW moments and step count) as port-native
npz files (utils/checkpoint.save_native) and meta.json; --resume continues
from them with the batches an uninterrupted run would see.

Usage (the card by default; --device cpu runs on the host):
  python -m freeze_omni_tpu_torch.bin.train --preset tiny --stage align \\
      --steps 20 --ckpt_dir /tmp/ckpt [--resume] [--batch 4] [--lr 1e-3] \\
      [--manifest train.tsv --epochs 2 --tokenizer /path/to/hf_tokenizer]
The multi-host flags (--coordinator, --num_hosts, --host_id) exit: they
wait for ROADMAP.md D9b (data-parallel and multi-host training).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

_WAITING = ("coordinator", "num_hosts", "host_id")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="freeze-omni trainer (PyTorch)")
    p.add_argument("--preset", default="tiny", choices=["tiny", "flagship"])
    p.add_argument("--stage", default="all",
                   choices=["ctc", "align", "prompt", "state", "decoder",
                            "lora", "all"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' trains "
                        "on the host)")
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_targets", default="q,v",
                   help="comma-joined projection names for --stage lora "
                        "(among q,k,v,o,gate,up,down)")
    p.add_argument("--ctc_vocab", type=int, default=None,
                   help="CTC label-space size (default: 16 for synthetic "
                        "data; max manifest token id + 1 with --manifest)")
    p.add_argument("--manifest", default=None,
                   help="wav<TAB>transcript TSV for the ASR stages")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir (default: ByteTokenizer)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_decoder", action="store_true", default=True)
    # the JAX trainer's multi-host flags wait for ROADMAP D9b
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num_hosts", type=int, default=None)
    p.add_argument("--host_id", type=int, default=None)
    return p.parse_args(argv)


def stage_trees(stage: str, params: dict, extra):
    """(trainable, frozen) of one stage from the AudioLLM tree `params` and
    the stage's own new tree `extra`: the CTC head (ctc), the speech decoder
    (decoder, all) or the LoRA adapter (lora); None for the others."""
    pick = lambda *ks: {k: params[k] for k in ks}  # noqa: E731
    if stage == "ctc":
        return {"encoder_user": params["encoder_user"], "ctc_head": extra}, {}
    if stage == "align":
        return pick("encoder_user", "adapter_user"), pick("llm")
    if stage == "prompt":
        return (pick("prompt_embeddings"),
                pick("llm", "encoder_user", "adapter_user"))
    if stage == "state":
        return pick("encoder_user", "adapter_user", "predictor"), pick("llm")
    if stage == "decoder":
        return {"speech_decoder": extra}, {}
    if stage == "lora":
        return {"lora": extra}, pick("llm")
    trainable = pick("encoder_user", "adapter_user", "predictor")
    trainable["speech_decoder"] = extra
    return trainable, pick("llm")


def build_trees(stage: str, cfg, dcfg, seed: int, device, ctc_vocab: int,
                lora_rank: int = 8, lora_targets=("q", "v")):
    """(trainable, frozen) of one stage from seeded random weights: the
    AudioLLM from `seed`, the speech decoder from seed + 1, the CTC head
    from seed + 2 and the LoRA adapter from seed + 3."""
    from ..models import audio_llm
    from ..models import lora as lora_mod
    from ..models import speech_decoder as sd
    from ..training import train_step as ts

    def gen(k):
        return torch.Generator(device=device).manual_seed(seed + k)

    if stage in ("decoder", "all"):
        extra = sd.init_params(dcfg, gen(1), device=device)
    elif stage == "ctc":
        extra = ts.init_ctc_head(gen(2), cfg, ctc_vocab, device)
    elif stage == "lora":
        extra = lora_mod.init(cfg.llm, gen(3), rank=lora_rank,
                              targets=tuple(lora_targets), device=device)
    else:
        extra = None
    # the decoder stage trains the speech decoder alone: no AudioLLM draw
    params = {} if stage == "decoder" else audio_llm.init_params(
        cfg, seed=seed, device=device)
    return stage_trees(stage, params, extra)


def run(args) -> dict:
    """Train as the flags say. Returns the summary with each step's loss
    ("losses") and host seconds ("step_seconds")."""
    for flag in _WAITING:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} is not in the PyTorch port yet: it "
                             f"waits for ROADMAP.md D9b (multi-GPU training)")
    from .. import weights
    from ..config import flagship_system, tiny_system
    from ..training import data as data_mod
    from ..training import optim
    from ..training import train_step as ts
    from ..utils import checkpoint as ckpt_mod
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    sys_cfg = tiny_system() if args.preset == "tiny" else flagship_system()
    cfg, dcfg = sys_cfg.audio_llm, sys_cfg.tts.decoder

    tokenizer = None
    if args.manifest:
        from ..training import manifest as mani_mod
        from ..utils.tokenizer import ByteTokenizer, HFTokenizer

        if args.stage not in mani_mod.ASR_STAGES:
            raise SystemExit(f"--manifest covers stages "
                             f"{mani_mod.ASR_STAGES}, not {args.stage!r}")
        tokenizer = (HFTokenizer(args.tokenizer) if args.tokenizer
                     else ByteTokenizer(cfg.llm.vocab_size))
        if args.ctc_vocab is None and args.stage == "ctc":
            args.ctc_vocab = 1 + max(
                max(tokenizer.encode(t), default=0)
                for _, t in mani_mod.read_manifest(args.manifest))
    if args.ctc_vocab is None:
        args.ctc_vocab = 16
    if args.stage == "prompt":
        cfg = dataclasses.replace(cfg, prompt_finetune=True)

    trainable, frozen = build_trees(args.stage, cfg, dcfg, args.seed, device,
                                    args.ctc_vocab, args.lora_rank,
                                    args.lora_targets.split(","))
    start_step = 0
    latest = opt_path = None
    if args.ckpt_dir:
        latest = os.path.join(args.ckpt_dir, "latest", "params.npz")
        opt_path = os.path.join(args.ckpt_dir, "opt", "params.npz")
    if args.resume and latest and os.path.exists(latest):
        trainable = weights.from_jax(ckpt_mod.load_native(latest), device=device)
        with open(os.path.join(args.ckpt_dir, "meta.json")) as f:
            start_step = json.load(f)["step"]
    state = ts.init_train_state(trainable, lr=args.lr)
    del trainable
    if start_step:
        if os.path.exists(opt_path):
            saved = ckpt_mod.load_native(opt_path)
            optim.load_opt_state(state.optimizer, state.trainable, saved)
        else:
            print("no optimizer state in checkpoint; adamw moments reset",
                  flush=True)
        state.step = start_step
        print(f"resumed from step {start_step}", flush=True)

    if args.manifest:
        batch_iter = mani_mod.prefetch(mani_mod.manifest_batches(
            args.stage, args.manifest, tokenizer, cfg, args.batch,
            epochs=args.epochs, seed=args.seed + start_step))
    elif args.stage == "all":
        batch_iter = data_mod.batches(cfg, dcfg, args.batch, args.steps,
                                      seed=args.seed + start_step,
                                      with_decoder=args.with_decoder)
    else:
        batch_iter = data_mod.stage_batches(args.stage, cfg, dcfg, args.batch,
                                            args.steps,
                                            seed=args.seed + start_step)
    losses, step_seconds = [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(batch_iter):
        if i >= args.steps:
            break
        ts_ = time.perf_counter()
        state, metrics = ts.stage_step(args.stage, state, frozen, cfg, dcfg,
                                       ts.to_tensors(batch, device))
        loss = float(metrics["loss"])   # waits for the step
        step_seconds.append(time.perf_counter() - ts_)
        losses.append(loss)
        step = start_step + i + 1
        if step % 5 == 0 or i == 0:
            print(f"step {step}: loss={loss:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and step % args.save_every == 0:
            ckpt_mod.save_native(latest, weights.to_numpy(state.trainable))
            # the moments in a sibling file, so `latest` stays a pure
            # params checkpoint
            opt = optim.opt_state(state.optimizer, state.trainable)
            ckpt_mod.save_native(opt_path, weights.to_numpy(opt))
            with open(os.path.join(args.ckpt_dir, "meta.json"), "w") as f:
                json.dump({"step": step, "loss": loss}, f)
            print(f"saved checkpoint at step {step}", flush=True)

    if args.stage == "lora" and args.ckpt_dir:
        from ..models import lora as lora_mod

        os.makedirs(args.ckpt_dir, exist_ok=True)
        lora_path = os.path.join(args.ckpt_dir, "lora.npz")
        lora_mod.save(lora_path, state.trainable["lora"])
        print(f"saved LoRA adapter to {lora_path}", flush=True)

    if not losses:
        raise SystemExit("no training step ran (--steps 0 or an empty manifest)")
    return {"final_step": start_step + len(losses),
            "first_loss": round(losses[0], 4),
            "final_loss": round(losses[-1], 4),
            "losses": losses, "step_seconds": step_seconds}


def main(argv=None) -> dict:
    out = run(get_args(argv))
    print(json.dumps({k: out[k] for k in ("final_step", "first_loss",
                                          "final_loss")}))
    return out


if __name__ == "__main__":
    main()
