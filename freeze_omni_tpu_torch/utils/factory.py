"""Model factory: systems from reference checkpoint directories and from the
port-native format (counterpart of freeze_omni_tpu/utils/factory.py).

Parity with models/utils.init_encoder_llm + load_checkpoint and the loaders
in models/pipeline.py:11-34 and models/decoder/llm2tts.py:17-68 of the
reference: reads `<model_path>/audiollm/train.yaml` + `global_cmvn` +
`final.pt`, the HF LLM at `llm_path` (its `config.json` and safetensors
weights, read without transformers), `<model_path>/decoder/{model.json,
final.pt}` and `<model_path>/codec/{model.json,final.pt}`, and converts
everything into the parameter trees both packages share.

The `load_*` functions return numpy trees on the host, as the JAX ones do;
`build_system_from_reference` and `load_native_system` return tensors on a
device (None: the CUDA card, raising without one). A port-native system is
a directory of `config.json` (the config tree as JSON), `params.npz`
(`utils.checkpoint.save_native`) and an optional `tokenizer/` (the HF
tokenizer files copied at conversion). The committed trained tiny system
(`TINY_S2S`) holds `chunks.json` in place of `params.npz`: an index over the
JAX package's orbax chunks, read for that directory only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple

from ..config import (AudioLLMConfig, CodecConfig, LLMConfig,
                      SpeechDecoderConfig, SystemConfig, assign_from_dict,
                      flagship_system, from_reference_train_yaml, read_yaml)
from . import checkpoint as ckpt

TINY_S2S = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "tiny_s2s")


def load_audiollm(model_path: str) -> Tuple[AudioLLMConfig, dict]:
    """-> (config from train.yaml, converted audiollm params with CMVN)."""
    configs = read_yaml(os.path.join(model_path, "audiollm", "train.yaml"))
    cfg = from_reference_train_yaml(configs)

    sd = ckpt.load_torch_state_dict(
        os.path.join(model_path, "audiollm", "final.pt"))
    params = ckpt.convert_audiollm(sd, cfg)

    cmvn_path = os.path.join(model_path, "audiollm", "global_cmvn")
    if os.path.exists(cmvn_path):
        from ..frontend.cmvn import load_cmvn

        mean, istd = load_cmvn(cmvn_path, configs.get("is_json_cmvn", True))
        for who in ("encoder_user", "encoder_system"):
            # the stats file only seeds the normalizer: global_cmvn buffers
            # in final.pt win, as in the reference's load order
            params[who].setdefault("cmvn", {"mean": mean, "istd": istd})
    return cfg, params


def load_llm(llm_path: str, cfg: AudioLLMConfig) -> Tuple[LLMConfig, dict]:
    """HF Qwen2 weights (audioLLM.py:70-74) -> (LLMConfig from the HF
    config.json, backbone tree). The HF config is authoritative for the
    backbone's shape; a key it lacks takes Qwen2Config's default. The leaves
    keep the files' dtypes (bfloat16 as ml_dtypes bfloat16)."""
    from .safetensors import load_dir

    with open(os.path.join(llm_path, "config.json")) as f:
        h = json.load(f)
    rope = h.get("rope_parameters") or {}  # where newer configs keep it
    heads = h["num_attention_heads"]
    llm_cfg = dataclasses.replace(
        cfg.llm,
        hidden=h["hidden_size"], num_layers=h["num_hidden_layers"],
        num_heads=heads, num_kv_heads=h.get("num_key_value_heads") or heads,
        ffn=h["intermediate_size"], vocab_size=h["vocab_size"],
        rope_theta=float(h.get("rope_theta", rope.get("rope_theta", 10000.0))),
        rms_eps=float(h.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(h.get("tie_word_embeddings", False)))
    return llm_cfg, ckpt.convert_hf_qwen2(load_dir(llm_path), llm_cfg)


def load_speech_decoder(model_path: str) -> Tuple[SpeechDecoderConfig, dict]:
    """decoder/model.json is [idim, odim, args] (llm2tts.py:32-39)."""
    with open(os.path.join(model_path, "decoder", "model.json")) as f:
        idim, odim, args = json.load(f)
    cfg = SpeechDecoderConfig(
        idim=idim, hidden=args.get("transformer_attention_dim", idim),
        num_layers=args.get("transformer_num_blocks", 4),
        num_heads=args.get("transformer_attention_heads", 14),
        ffn=args.get("transformer_linear_units", 4864),
        codec_vocab=odim,
        use_prefix_kv=bool(args.get("kv_cache_prefix_finetune", 0)),
    )
    sd = ckpt.load_torch_state_dict(
        os.path.join(model_path, "decoder", "final.pt"))
    return cfg, ckpt.convert_speech_decoder(sd, cfg)


def load_codec(model_path: str) -> Tuple[CodecConfig, dict]:
    with open(os.path.join(model_path, "codec", "model.json")) as f:
        h = json.load(f)
    # map the reference's key spellings onto the typed config
    if "residul_layer" in h:  # sic (models.py:548)
        h = {**h, "residual_layers": h["residul_layer"]}
    cfg = assign_from_dict(CodecConfig(), h)
    torch_ckpt = ckpt.load_torch_state_dict(
        os.path.join(model_path, "codec", "final.pt"))
    return cfg, ckpt.convert_codec(torch_ckpt, cfg,
                                   with_encoder="encoder" in torch_ckpt)


_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                    "merges.txt", "special_tokens_map.json",
                    "added_tokens.json", "chat_template.jinja")


def load_tokenizer(llm_path: str, vocab_size: int):
    """The HF tokenizer of a local directory (real weights need the real
    Qwen2 BPE, audioLLM.py:73-74), else the ByteTokenizer fallback, which
    only suits weightless or synthetic runs: its decode drops ids >= 256. A
    directory without tokenizer files takes the fallback without asking
    transformers, some versions of which build an empty tokenizer there."""
    from .tokenizer import ByteTokenizer, HFTokenizer

    if not (llm_path and os.path.isdir(llm_path)):
        reason = "no such directory"
    elif not any(os.path.isfile(os.path.join(llm_path, name))
                 for name in _TOKENIZER_FILES):
        reason = "no tokenizer files"
    else:
        try:
            return HFTokenizer(llm_path)
        except Exception as e:  # unusable tokenizer files: the fallback below
            reason = repr(e)
    print(f"[tokenizer] no usable HF tokenizer at {llm_path!r} ({reason}); "
          "falling back to ByteTokenizer (synthetic-weights mode)")
    return ByteTokenizer(vocab_size)


def _to(tree, device):
    """A tree of CPU tensors moved to `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def build_system_from_reference(model_path: str, llm_path: str, *,
                                quantize_llm_bits: Optional[int] = None,
                                device=None
                                ) -> Tuple[SystemConfig, dict, dict, object]:
    """Full reference loader: returns (system config, audio_llm params with
    the LLM, tts params {'decoder', 'codec'}, tokenizer), every tree on
    `device`.

    quantize_llm_bits: 8 (or 4) quantizes the frozen backbone weight-only on
    the host CPU (`ops.quant.quantize_llm_params`, the layout
    `init_quantized_llm` draws) before it reaches the device, so the bf16
    tree never occupies the card."""
    from ..ops.quant import quantize_llm_params
    from ..utils.device import resolve_device
    from ..weights import from_jax

    dev = resolve_device(device)
    acfg, audiollm = load_audiollm(model_path)
    llm_cfg, llm = load_llm(llm_path, acfg)
    if quantize_llm_bits:
        llm = _to(quantize_llm_params(from_jax(llm, device="cpu"),
                                      bits=quantize_llm_bits), dev)
    else:
        llm = from_jax(llm, dev)
    audiollm = from_jax(audiollm, dev)
    audiollm["llm"] = llm
    acfg = dataclasses.replace(acfg, llm=llm_cfg)
    dcfg, dec = load_speech_decoder(model_path)
    ccfg, codec = load_codec(model_path)

    base = flagship_system()
    cfg = dataclasses.replace(
        base, audio_llm=acfg,
        tts=dataclasses.replace(base.tts, decoder=dcfg, codec=ccfg))
    tokenizer = load_tokenizer(llm_path, llm_cfg.vocab_size)
    return cfg, audiollm, from_jax({"decoder": dec, "codec": codec}, dev), tokenizer


def load_system(model_path: str, llm_path: Optional[str] = None, *,
                quantize_llm_bits: Optional[int] = None, device=None
                ) -> Tuple[SystemConfig, dict, dict, object]:
    """A port-native system dir, or a reference checkpoint dir with its HF
    LLM dir: the 4-tuple of build_system_from_reference, on `device`."""
    if is_native_system(model_path):
        return load_native_system(model_path, device=device)
    return build_system_from_reference(model_path, llm_path,
                                       quantize_llm_bits=quantize_llm_bits,
                                       device=device)


def save_native_system(out_dir: str, cfg: SystemConfig, audiollm: dict,
                       tts: dict, llm_path: Optional[str] = None) -> None:
    """Persist a converted (optionally quantized) system in the port-native
    format: `params.npz` + `config.json` + a copy of the HF tokenizer files,
    so the system serves where the HF dir is absent. Restarting from it
    skips the torch load and the quantization. The trees may hold tensors
    on any device or numpy arrays."""
    os.makedirs(out_dir, exist_ok=True)
    ckpt.save_native(os.path.join(out_dir, "params.npz"),
                     {"audiollm": audiollm, "tts": tts})
    if llm_path and os.path.isdir(llm_path):
        tok_dir = os.path.join(out_dir, "tokenizer")
        os.makedirs(tok_dir, exist_ok=True)
        for name in _TOKENIZER_FILES:
            src = os.path.join(llm_path, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(tok_dir, name))
    doc = dataclasses.asdict(cfg)
    doc["_native_system"] = True
    doc["_llm_path"] = llm_path  # provenance; tokenizer/ is preferred at load
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(doc, f)


def _is_tiny_s2s(path: str) -> bool:
    return os.path.isdir(path) and os.path.samefile(path, TINY_S2S)


def is_native_system(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "config.json")) and (
        os.path.isfile(os.path.join(path, "params.npz")) or _is_tiny_s2s(path))


def load_native_system(path: str, *, device=None) -> Tuple[SystemConfig, dict, dict, object]:
    """Load a `save_native_system` directory onto `device`: returns the same
    4-tuple as build_system_from_reference.

    Prefers the tokenizer files copied into `<path>/tokenizer`; falls back
    to the recorded HF dir. A real-vocab config that would end up on the
    ByteTokenizer (its decode drops ids >= 256: generations would come out
    empty) is an error."""
    from ..config import load_system_config
    from ..utils.device import resolve_device
    from ..weights import from_jax
    from .tokenizer import ByteTokenizer

    dev = resolve_device(device)
    cfg_path = os.path.join(path, "config.json")
    cfg = load_system_config(cfg_path)
    with open(cfg_path) as f:
        doc = json.load(f)
    vocab = cfg.audio_llm.llm.vocab_size
    local_tok = os.path.join(path, "tokenizer")
    tok_path = local_tok if os.path.isdir(local_tok) \
        else (doc.get("_llm_path") or "")
    tokenizer = load_tokenizer(tok_path, vocab)
    if isinstance(tokenizer, ByteTokenizer) and vocab > 4096:
        raise RuntimeError(
            f"native checkpoint at {path} has vocab_size={vocab} but no "
            "usable tokenizer (no tokenizer/ copy in the checkpoint and no "
            f"HF dir at {doc.get('_llm_path')!r}). Serving with the "
            "ByteTokenizer fallback would emit empty text. Re-run "
            "bin/convert_ckpt.py with --llm_path pointing at the HF dir.")
    npz = os.path.join(path, "params.npz")
    params = (ckpt._load_chunk_index(os.path.join(path, "chunks.json"))
              if _is_tiny_s2s(path) else ckpt.load_native(npz))
    return (cfg, from_jax(params["audiollm"], dev), from_jax(params["tts"], dev),
            tokenizer)
