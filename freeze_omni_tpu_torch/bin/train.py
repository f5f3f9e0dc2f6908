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

Data parallelism, as the JAX CLI's: on a host with more than one card and
a --batch they divide, the run is data-parallel over the cards, one process
a card (this process, rank 0, starts the others with its own command line
and their place in FO_TRAIN_RANK); otherwise it says so and trains on one
card. `--coordinator host:port --num_hosts N --host_id h` (or the
FO_COORDINATOR / FO_NUM_HOSTS / FO_HOST_ID env triple) joins N hosts, one
process a card of each (one process a host with --device cpu); --batch
must divide by the job's processes. Every process builds the same global
batch and trains on its contiguous rows; the loss of each step is the
global batch's (training/train_step.loss_denominators) and the gradients
are summed over the processes before the AdamW step. The trainable tree and
the optimizer state go out from rank 0 after init or --resume (every
process loads the checkpoint), so the replicas stay bit-identical; only
rank 0 prints the steps and writes `latest`, `opt`, meta.json and
lora.npz, and every process prints the summary with its host_id, rank and
param_checksum. The processes meet over NCCL with a card each and over
gloo for --device cpu. Only the CLI (`main`) starts processes: `run()`
trains in a job its caller already joined, over --coordinator's hosts one
process each, or in this process alone.

Usage (the card by default; --device cpu runs on the host):
  python -m freeze_omni_tpu_torch.bin.train --preset tiny --stage align \\
      --steps 20 --ckpt_dir /tmp/ckpt [--resume] [--batch 4] [--lr 1e-3] \\
      [--manifest train.tsv --epochs 2 --tokenizer /path/to/hf_tokenizer]
  # two CPU "hosts" (run each line in its own shell):
  python -m freeze_omni_tpu_torch.bin.train --device cpu --batch 8 \\
      --coordinator 127.0.0.1:29500 --num_hosts 2 --host_id 0
  python -m freeze_omni_tpu_torch.bin.train --device cpu --batch 8 \\
      --coordinator 127.0.0.1:29500 --num_hosts 2 --host_id 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import torch

# a local rank started by rank 0 of its host runs its command line and gets
# its place in the job through this
_RANK_ENV = "FO_TRAIN_RANK"
SUMMARY_KEYS = ("final_step", "first_loss", "final_loss", "host_id", "rank",
                "param_checksum")


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
    # multi-host: one trainer process a card of each host; the gradients are
    # summed across processes once a step (parallel/multihost.py)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0: enables multi-host "
                        "(env: FO_COORDINATOR/FO_NUM_HOSTS/FO_HOST_ID)")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    args = p.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


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


class _Job:
    """The processes a run trains over: `group` None for one process, else
    the world group of `world` ranks (this one `rank`, on `device`);
    `owned` when this run joined the job (and leaves it at the end),
    `started` the local ranks this process started."""

    def __init__(self, device, group=None, rank=0, world=1, owned=False,
                 started: Optional[List[subprocess.Popen]] = None):
        self.device, self.group, self.rank, self.world = device, group, rank, world
        self.owned, self.started = owned, started or []

    def leave(self, timeout: float = 600.0) -> None:
        """Meet the other ranks, leave the job this run joined, and reap
        the ranks this process started (raises if one failed)."""
        from ..parallel import multihost as mh

        if not self.owned:
            return
        mh.sync("train-done")
        mh.shutdown()
        codes = mh.reap_ranks(self.started, timeout)
        if any(codes):
            raise SystemExit(f"a local training rank exited with {codes}")


def join_job(args, local_ranks: bool = False) -> _Job:
    """The job of a run, as the JAX CLI lays out its devices: a job the
    caller already joined (torch.distributed initialized: every rank of it
    trains); --coordinator's hosts, --batch divisible by all their
    processes; else one process. With `local_ranks` (the CLI's main), a
    host with more than one card runs a process a card where --batch
    divides by them, rank 0 starting the others with its command line
    (multihost.join_local_ranks); without it, one process a host."""
    import torch.distributed as dist

    from ..parallel import multihost as mh
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    if dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return _Job(dev, dist.group.WORLD, dist.get_rank(), dist.get_world_size())
    job = mh.resolve_job(args.coordinator, args.num_hosts, args.host_id)
    # a process a card of the host; a named card (cuda:i) is one
    cards = torch.cuda.device_count() \
        if local_ranks and dev.type == "cuda" and dev.index is None else 1
    if job is not None:
        n_dev = job[1] * cards
        if args.batch % n_dev:
            raise SystemExit(f"multi-host requires --batch divisible by the "
                             f"global device count {n_dev}, got {args.batch}")
    elif cards > 1 and args.batch % cards:
        print(f"{cards} devices but batch {args.batch} not divisible; "
              f"running single-device", flush=True)
        cards = 1
    if job is None and cards == 1:
        return _Job(dev)
    dev, started = mh.join_local_ranks(
        "freeze_omni_tpu_torch.bin.train", args.argv, cards, _RANK_ENV,
        args.device, args.coordinator, args.num_hosts, args.host_id)
    if mh.is_primary() or job is not None:
        print(f"multi-host data-parallel: {job[1]} hosts x {cards} devices"
              if job is not None else f"data-parallel over {cards} devices",
              flush=True)
    return _Job(dev, dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                owned=True, started=started)


def run(args, system=None, job: Optional[_Job] = None) -> dict:
    """Train as the flags say (`system`: a SystemConfig to train instead of
    the preset's) over `job`, by default join_job(args): run() starts no
    process. At the end it leaves a job join_job joined (`owned`), and
    reaps the ranks started for it. Returns the summary with each
    step's loss ("losses"), host seconds ("step_seconds") and the final
    TrainState ("state")."""
    from .. import weights
    from ..config import flagship_system, tiny_system
    from ..parallel import multihost as mh
    from ..training import data as data_mod
    from ..training import optim
    from ..training import train_step as ts
    from ..utils import checkpoint as ckpt_mod

    job = job or join_job(args)
    device, dp = job.device, job.group
    primary = mh.is_primary()
    sys_cfg = system or (tiny_system() if args.preset == "tiny" else flagship_system())
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
    if dp is not None:
        ts.broadcast_train_state(state, dp)

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
        denoms = None
        if dp is not None:
            # the global batch's denominators, then this rank's rows
            denoms = ts.loss_denominators(args.stage, batch)
            batch = mh.local_batch_slice(batch, job.world, job.rank)
        ts_ = time.perf_counter()
        state, metrics = ts.stage_step(args.stage, state, frozen, cfg, dcfg,
                                       ts.to_tensors(batch, device), denoms, dp)
        loss = float(metrics["loss"])   # waits for the step
        step_seconds.append(time.perf_counter() - ts_)
        losses.append(loss)
        step = start_step + i + 1
        if (step % 5 == 0 or i == 0) and primary:
            print(f"step {step}: loss={loss:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and step % args.save_every == 0 and primary:
            ckpt_mod.save_native(latest, weights.to_numpy(state.trainable))
            # the moments in a sibling file, so `latest` stays a pure
            # params checkpoint
            opt = optim.opt_state(state.optimizer, state.trainable)
            ckpt_mod.save_native(opt_path, weights.to_numpy(opt))
            with open(os.path.join(args.ckpt_dir, "meta.json"), "w") as f:
                json.dump({"step": step, "loss": loss}, f)
            print(f"saved checkpoint at step {step}", flush=True)

    if args.stage == "lora" and args.ckpt_dir and primary:
        from ..models import lora as lora_mod

        os.makedirs(args.ckpt_dir, exist_ok=True)
        lora_path = os.path.join(args.ckpt_dir, "lora.npz")
        lora_mod.save(lora_path, state.trainable["lora"])
        print(f"saved LoRA adapter to {lora_path}", flush=True)

    if not losses:
        raise SystemExit("no training step ran (--steps 0 or an empty manifest)")
    out = {"final_step": start_step + len(losses),
           "first_loss": round(losses[0], 4),
           "final_loss": round(losses[-1], 4)}
    if dp is not None:
        # every rank reports; the checksum probes the replicas for
        # divergence (they hold the same parameters)
        out.update(host_id=mh.host_index(), rank=job.rank,
                   param_checksum=round(mh.tree_checksum(state.trainable), 6))
    job.leave()
    return dict(out, losses=losses, step_seconds=step_seconds, state=state)


def main(argv=None) -> dict:
    args = get_args(argv)
    out = run(args, job=join_job(args, local_ranks=True))
    print(json.dumps({k: out[k] for k in SUMMARY_KEYS if k in out}), flush=True)
    return out


if __name__ == "__main__":
    main()
