"""Checkpoint conversion and the port-native save/load (counterpart of
freeze_omni_tpu/utils/checkpoint.py).

The reference loads `checkpoints/audiollm/final.pt` (strict=False partial
load, models/utils.py:11-28), the HF Qwen2-7B-Instruct weights
(models/audioLLM.py:70-74), `checkpoints/decoder/final.pt`
(models/decoder/llm2tts.py:41-68) and `checkpoints/codec/final.pt` (split
into generator/quantizer/encoder, ticodec/vqvae.py:21-35). The converters
below turn those torch state dicts into the parameter trees both packages
share (torch's [out, in] linear layout transposed to [in, out], buffers
folded, layers stacked), as numpy: `weights.from_jax` moves such a tree to a
device.

The port-native format is one uncompressed `params.npz` whose entries are
the tree's leaves, keyed by their paths, plus one JSON entry (`__index__`)
that records the tree's shape (dicts, lists, tuples, None) and each leaf's
dtype, so the tree comes back as it went in. The writer fixes every zip
timestamp, so the same tree always gives the same bytes. bfloat16 leaves
(numpy dtype 'bfloat16', as ml_dtypes defines it) are stored as their
16-bit patterns. The committed trained tiny system alone is kept as a small
index over the JAX package's zstd chunks instead (`_save_chunk_index` /
`_load_chunk_index`, below; `utils.factory` reads it for that directory
only).

Conversion is name-driven; missing optional keys are skipped (the
reference's strict=False semantics).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import hashlib
import json
import os
import zipfile
from typing import List

import numpy as np

from ..config import (AdapterConfig, AudioLLMConfig, CodecConfig, EncoderConfig,
                      LLMConfig, SpeechDecoderConfig)


def _t(x) -> np.ndarray:
    """torch tensor / array -> numpy array of the same dtype. bfloat16
    tensors become ml_dtypes bfloat16 arrays over the same bits."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        import torch

        if x.dtype == torch.bfloat16:
            import ml_dtypes

            return x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        x = x.numpy()
    return np.asarray(x)


def _linear(sd: dict, name: str, bias: bool = True) -> dict:
    p = {"w": _t(sd[f"{name}.weight"]).T}  # torch [out,in] -> ours [in,out]
    if bias and f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _ln(sd: dict, name: str) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _rms(sd: dict, name: str) -> dict:
    return {"scale": _t(sd[f"{name}.weight"])}


def _bn(sd: dict, name: str) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"]),
            "mean": _t(sd[f"{name}.running_mean"]),
            "var": _t(sd[f"{name}.running_var"])}


def _conv1d(sd: dict, name: str) -> dict:
    p = {"w": _t(sd[f"{name}.weight"])}  # [out, in, k] matches ours
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _stack(layers: List[dict]) -> dict:
    """Per-layer dicts of the same shape -> one dict of [L, ...] leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return np.stack(layers)


# ---------------------------------------------------------------------------
# speech encoder (audiollm ckpt, prefix e.g. 'encoder_user.')
# ---------------------------------------------------------------------------


def convert_encoder(sd: dict, cfg: EncoderConfig, prefix: str) -> dict:
    """Keys per models/encoder/*: {prefix}enc.0 = Subsampling, {prefix}enc.1 =
    Transformer; cmvn under {prefix}global_cmvn."""
    out = {}
    if f"{prefix}global_cmvn.mean" in sd:
        # GlobalCMVN registers mean/istd as buffers: when the checkpoint
        # carries them they win over the global_cmvn stats file (the
        # reference builds from the file, then the strict=False load
        # overwrites)
        out["cmvn"] = {
            "mean": _t(sd[f"{prefix}global_cmvn.mean"]),
            "istd": _t(sd[f"{prefix}global_cmvn.istd"]),
        }
    sub = f"{prefix}enc.0.core"
    out["sub"] = {
        "conv1": {"w": _t(sd[f"{sub}.conv.0.weight"]),
                  "b": _t(sd[f"{sub}.conv.0.bias"])},
        "conv2": {"w": _t(sd[f"{sub}.conv.2.weight"]),
                  "b": _t(sd[f"{sub}.conv.2.bias"])},
        "out": _linear(sd, f"{sub}.out.0"),
    }
    tr = f"{prefix}enc.1"
    out["embed"] = {"lin": _linear(sd, f"{tr}.embed.0"),
                    "ln": _ln(sd, f"{tr}.embed.1")}
    blocks = []
    for i in range(cfg.num_blocks):
        b = f"{tr}.encoders.{i}"
        blk = {
            "ln1": _ln(sd, f"{b}.norm1"),
            "q": _linear(sd, f"{b}.self_attn.linear_q"),
            "k": _linear(sd, f"{b}.self_attn.linear_k"),
            "v": _linear(sd, f"{b}.self_attn.linear_v"),
            "o": _linear(sd, f"{b}.self_attn.linear_out"),
            "ln2": _ln(sd, f"{b}.norm2"),
        }
        if cfg.pos_enc == "rel-enc":
            # abs-enc checkpoints carry no linear_pos / pos biases
            blk["pos"] = _linear(sd, f"{b}.self_attn.linear_pos", bias=False)
            blk["bias_u"] = _t(sd[f"{b}.self_attn.pos_bias_u"])
            blk["bias_v"] = _t(sd[f"{b}.self_attn.pos_bias_v"])
        if f"{b}.feed_forward.w_1.0.weight" in sd:
            # Conv1dLinear positionwise
            blk["ffn_dw"] = _conv1d(sd, f"{b}.feed_forward.w_1.0")
            blk["ffn_pw"] = _conv1d(sd, f"{b}.feed_forward.w_1.1")
            blk["ffn2"] = _linear(sd, f"{b}.feed_forward.w_2")
        elif _t(sd[f"{b}.feed_forward.w_1.weight"]).ndim == 3:
            # MultiLayeredConv1d positionwise
            blk["ffn_c1"] = _conv1d(sd, f"{b}.feed_forward.w_1")
            blk["ffn_c2"] = _conv1d(sd, f"{b}.feed_forward.w_2")
        else:
            blk["ffn1"] = _linear(sd, f"{b}.feed_forward.w_1")
            blk["ffn2"] = _linear(sd, f"{b}.feed_forward.w_2")
        blocks.append(blk)
    out["blocks"] = _stack(blocks)
    out["after_norm"] = _ln(sd, f"{tr}.after_norm")
    return out


def convert_adapter(sd: dict, cfg: AdapterConfig, prefix: str) -> dict:
    out = {}
    if cfg.two_stage:
        out["conv1"] = _conv1d(sd, f"{prefix}conv1d1")
        out["bn1"] = _bn(sd, f"{prefix}bn1")
    out["conv2"] = _conv1d(sd, f"{prefix}conv1d2")
    if f"{prefix}bn2.running_mean" in sd:
        out["bn2"] = _bn(sd, f"{prefix}bn2")
    else:
        out["bn2"] = _ln(sd, f"{prefix}bn2")
    out["proj"] = _linear(sd, f"{prefix}project")
    return out


# ---------------------------------------------------------------------------
# Qwen2 backbone (HF state dict)
# ---------------------------------------------------------------------------


def convert_hf_qwen2(sd: dict, cfg: LLMConfig, prefix: str = "model.") -> dict:
    layers = []
    for i in range(cfg.num_layers):
        b = f"{prefix}layers.{i}"
        layers.append({
            "ln1": _rms(sd, f"{b}.input_layernorm"),
            "q": _linear(sd, f"{b}.self_attn.q_proj", bias=cfg.qkv_bias),
            "k": _linear(sd, f"{b}.self_attn.k_proj", bias=cfg.qkv_bias),
            "v": _linear(sd, f"{b}.self_attn.v_proj", bias=cfg.qkv_bias),
            "o": _linear(sd, f"{b}.self_attn.o_proj", bias=False),
            "ln2": _rms(sd, f"{b}.post_attention_layernorm"),
            "gate": _linear(sd, f"{b}.mlp.gate_proj", bias=False),
            "up": _linear(sd, f"{b}.mlp.up_proj", bias=False),
            "down": _linear(sd, f"{b}.mlp.down_proj", bias=False),
        })
    params = {
        "embed": {"w": _t(sd[f"{prefix}embed_tokens.weight"])},
        "layers": _stack(layers),
        "final_norm": _rms(sd, f"{prefix}norm"),
    }
    if not cfg.tie_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"w": _t(sd["lm_head.weight"]).T}
    return params


def convert_audiollm(sd: dict, cfg: AudioLLMConfig) -> dict:
    """checkpoints/audiollm/final.pt -> encoder/adapter/predictor trees (the
    LLM itself comes from the HF checkpoint)."""
    out = {
        "encoder_user": convert_encoder(sd, cfg.encoder, "encoder_user."),
        "encoder_system": convert_encoder(sd, cfg.encoder, "encoder_system."),
        "adapter_user": convert_adapter(sd, cfg.adapter, "adpter_user."),
        "adapter_system": convert_adapter(sd, cfg.adapter, "adpter_system."),
    }
    if "predictor_head.weight" in sd:
        out["predictor"] = _linear(sd, "predictor_head")
    # task/prompt/prefix-tuning tables (audioLLM.py:169-195)
    if "task_embeddings.weight" in sd:
        out["task_embeddings"] = _t(sd["task_embeddings.weight"])
    if "prompt_embeddings.weight" in sd:
        out["prompt_embeddings"] = _t(sd["prompt_embeddings.weight"])
    if "prefix_embeddings.0.0.weight" in sd:
        L = cfg.llm.num_layers
        out["prefix_embeddings"] = np.stack([
            np.stack([_t(sd[f"prefix_embeddings.{i}.0.weight"]),
                      _t(sd[f"prefix_embeddings.{i}.1.weight"])])
            for i in range(L)])
    return out


# ---------------------------------------------------------------------------
# speech decoder + codec
# ---------------------------------------------------------------------------


def _llama_layer(sd: dict, b: str) -> dict:
    return {
        "ln1": _rms(sd, f"{b}.input_layernorm"),
        "q": _linear(sd, f"{b}.self_attn.q_proj", bias=False),
        "k": _linear(sd, f"{b}.self_attn.k_proj", bias=False),
        "v": _linear(sd, f"{b}.self_attn.v_proj", bias=False),
        "o": _linear(sd, f"{b}.self_attn.o_proj", bias=False),
        "ln2": _rms(sd, f"{b}.post_attention_layernorm"),
        "gate": _linear(sd, f"{b}.mlp.gate_proj", bias=False),
        "up": _linear(sd, f"{b}.mlp.up_proj", bias=False),
        "down": _linear(sd, f"{b}.mlp.down_proj", bias=False),
    }


def convert_speech_decoder(sd: dict, cfg: SpeechDecoderConfig) -> dict:
    out = {
        "embedding": {"w": _t(sd["embedding.weight"])},
        "pre_nn": _stack([_llama_layer(sd, f"layers_pre_nn.{i}")
                          for i in range(cfg.num_pre_nn_layers)]),
        "layers": _stack([_llama_layer(sd, f"layers.{i}")
                          for i in range(cfg.num_layers)]),
        "final_norm": _rms(sd, "norm"),
        "out": _linear(sd, "out_fnn"),
    }
    if cfg.use_prefix_kv and "layers_prefix.0.input_layernorm.weight" in sd:
        out["prefix"] = _stack([_llama_layer(sd, f"layers_prefix.{i}")
                                for i in range(cfg.num_layers)])
    return out


def _fold_weight_norm(sd: dict, name: str) -> dict:
    """Collapse weight-norm (weight_g/weight_v) to a plain conv weight, as the
    reference does at inference via remove_weight_norm (llm2tts.py:28-29)."""
    if f"{name}.weight" in sd:
        p = {"w": _t(sd[f"{name}.weight"])}
    else:
        g = _t(sd[f"{name}.weight_g"])
        v = _t(sd[f"{name}.weight_v"])
        norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
        p = {"w": g * v / np.maximum(norm, 1e-12)}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def convert_codec(ckpt: dict, cfg: CodecConfig, with_encoder: bool = False) -> dict:
    gen_sd = ckpt["generator"]
    quant_sd = ckpt["quantizer"]
    nk = len(cfg.resblock_kernel_sizes)
    nd = len(cfg.resblock_dilation_sizes[0])

    def resblock(sd, b):
        return {
            "convs1": [_fold_weight_norm(sd, f"{b}.convs1.{j}") for j in range(nd)],
            "convs2": [_fold_weight_norm(sd, f"{b}.convs2.{j}") for j in range(nd)],
        }

    gen = {
        "conv_pre": _fold_weight_norm(gen_sd, "conv_pre"),
        "ups": [_fold_weight_norm(gen_sd, f"ups.{i}")
                for i in range(len(cfg.upsample_rates))],
        "resblocks": [resblock(gen_sd, f"resblocks.{i}")
                      for i in range(len(cfg.upsample_rates) * nk)],
        "conv_post": _fold_weight_norm(gen_sd, "conv_post"),
    }

    def q_modules(base: str):
        return [_t(quant_sd[f"{base}.{g}.embedding.weight"])
                for g in range(cfg.n_code_groups)]

    codebooks = [np.stack(q_modules("quantizer_modules"))]
    if cfg.residual_layers >= 2:
        codebooks.append(np.stack(q_modules("quantizer_modules2")))
    if cfg.residual_layers == 4:
        codebooks.append(np.stack(q_modules("quantizer_modules3")))
        codebooks.append(np.stack(q_modules("quantizer_modules4")))
    gst = np.stack([_t(quant_sd[f"quantizer_modules_globaltokens.{g}.embedding.weight"])
                    for g in range(cfg.global_code_num)])

    out = {"generator": gen,
           "quantizer": {"codebooks": codebooks, "gst": gst}}

    if with_encoder and "encoder" in ckpt:
        enc_sd = ckpt["encoder"]
        n_ups = len(cfg.upsample_rates)
        gns = []
        for i in range(n_ups):
            for j in range(nk):
                idx = i * nk + j
                gns.append({"scale": _t(enc_sd[f"normalize.{idx}.weight"]),
                            "bias": _t(enc_sd[f"normalize.{idx}.bias"])})
        out["encoder"] = {
            "conv_pre": _fold_weight_norm(enc_sd, "conv_pre"),
            "ups": [_fold_weight_norm(enc_sd, f"ups.{i}") for i in range(n_ups)],
            "resblocks": [resblock(enc_sd, f"resblocks.{i}")
                          for i in range(n_ups * nk)],
            "group_norms": gns,
            "conv_post": _conv1d(enc_sd, "conv_post"),
            "gte": {
                "conv1": _conv1d(enc_sd, "GlobalTokenEncoder.conv.0"),
                "conv2": _conv1d(enc_sd, "GlobalTokenEncoder.conv.2"),
                "conv3": _conv1d(enc_sd, "GlobalTokenEncoder.conv.4"),
                "fn": _linear(enc_sd, "GlobalTokenEncoder.fn.0"),
                "bn": _bn(enc_sd, "GlobalTokenEncoder.fn.2"),
            },
        }
    return out


def load_torch_state_dict(path: str) -> dict:
    """A reference `final.pt`. weights_only=False is explicit: recent torch
    defaults it to True, and a reference checkpoint may hold more than
    tensors. Load only files you trust: unpickling can run code."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


# ---------------------------------------------------------------------------
# port-native save/load: one params.npz
# ---------------------------------------------------------------------------

_INDEX = "__index__"
_EPOCH = (1980, 1, 1, 0, 0, 0)  # the zip format's earliest timestamp


def _flatten(node, path: str, leaves: list):
    """Tree -> JSON-able index; appends (key, array, dtype name) to leaves."""
    if isinstance(node, dict):
        return {"dict": {k: _flatten(v, f"{path}/{k}", leaves)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_flatten(v, f"{path}/{i}", leaves)
                       for i, v in enumerate(node)]}
    if node is None:
        return None
    arr = _t(node)  # a tensor on any device, or an array
    key = path.lstrip("/") or "leaf"
    leaves.append((key, arr))
    return {"leaf": key, "dtype": arr.dtype.name}


def save_native(path: str, params) -> None:
    """Write `params` (a tree of numpy-convertible leaves) to one
    uncompressed npz at `path`. The same tree always gives the same bytes."""
    leaves: list = []
    index = _flatten(params, "", leaves)

    def entry(zf, name: str, arr: np.ndarray) -> None:
        info = zipfile.ZipInfo(name + ".npy", date_time=_EPOCH)
        info.compress_type = zipfile.ZIP_STORED
        info.external_attr = 0o644 << 16
        with zf.open(info, "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.ascontiguousarray(arr),
                                      allow_pickle=False)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        entry(zf, _INDEX, np.frombuffer(
            json.dumps(index).encode(), np.uint8))
        for key, arr in leaves:
            if arr.dtype.name == "bfloat16":
                arr = arr.view(np.uint16)
            entry(zf, key, arr)


def _unflatten(node, leaf):
    """The inverse of _flatten: `leaf(entry)` gives each leaf's array."""
    if node is None:
        return None
    if "dict" in node:
        return {k: _unflatten(v, leaf) for k, v in node["dict"].items()}
    if "list" in node:
        return [_unflatten(v, leaf) for v in node["list"]]
    if "tuple" in node:
        return tuple(_unflatten(v, leaf) for v in node["tuple"])
    return leaf(node)


def _as_dtype(arr: np.ndarray, name: str) -> np.ndarray:
    if name == "bfloat16":
        import ml_dtypes

        return arr.view(ml_dtypes.bfloat16)
    return arr


def load_native(path: str) -> dict:
    """Read a `save_native` npz (any path, relative or absolute) back into
    the tree that was saved, every leaf a numpy array of its saved dtype."""
    with np.load(os.fspath(path), allow_pickle=False) as z:
        index = json.loads(z[_INDEX].tobytes().decode())
        return _unflatten(index, lambda e: _as_dtype(z[e["leaf"]], e["dtype"]))


# ---------------------------------------------------------------------------
# a tree held as an index over another checkpoint's zstd chunks
# ---------------------------------------------------------------------------
#
# The trained tiny system lives in the JAX package as an orbax tree whose
# arrays are zstd-compressed chunks in its data files. A port-native copy of
# it in git would double the repository's size, so the port keeps an index
# instead (`chunks.json`): the tree's shape, and each leaf's dtype, shape and
# the sha256 of its bytes. Loading decompresses every zstd frame of the
# source directory's files (and the frames nested in them) with the
# system's libzstd and takes each leaf from the frame whose bytes hash to
# its sha256. A leaf no single frame holds (one stored across several
# frames, or missing) is an error that names it.

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class _ZBuf(ctypes.Structure):   # ZSTD_inBuffer / ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=1)
def _zstd():
    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_findFrameCompressedSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_findFrameCompressedSize.restype = ctypes.c_size_t
    lib.ZSTD_createDCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_ZBuf),
                                          ctypes.POINTER(_ZBuf)]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    return lib


def _zstd_frame(lib, src: int, n: int):
    """The whole zstd frame of n bytes at address `src` decompressed (its
    content size may be unrecorded, as a streaming writer leaves it), or
    None if it is not one."""
    ctx = lib.ZSTD_createDCtx()
    try:
        inp = _ZBuf(src, n, 0)
        out = ctypes.create_string_buffer(1 << 20)
        parts = []
        while True:
            o = _ZBuf(ctypes.addressof(out), len(out), 0)
            ret = lib.ZSTD_decompressStream(ctx, ctypes.byref(o), ctypes.byref(inp))
            if lib.ZSTD_isError(ret):
                return None
            parts.append(out.raw[:o.pos])
            if ret == 0:   # the frame is complete
                return b"".join(parts)
            if inp.pos == inp.size and o.pos < o.size:
                return None   # truncated
    finally:
        lib.ZSTD_freeDCtx(ctx)


def _zstd_frames(buf: bytes, out: dict, depth: int = 0) -> None:
    """Every whole zstd frame in `buf`, and the frames nested in those,
    decompressed into out[sha256] = bytes."""
    lib = _zstd()
    cbuf = (ctypes.c_char * len(buf)).from_buffer_copy(buf)
    base = ctypes.addressof(cbuf)
    i = buf.find(_ZSTD_MAGIC)
    while i >= 0:
        n = lib.ZSTD_findFrameCompressedSize(base + i, len(buf) - i)
        data = None if lib.ZSTD_isError(n) else _zstd_frame(lib, base + i, n)
        if data is None:   # magic bytes inside other data
            i = buf.find(_ZSTD_MAGIC, i + 1)
            continue
        out[hashlib.sha256(data).hexdigest()] = data
        if depth < 2:   # values stored inline in compressed index nodes
            _zstd_frames(data, out, depth + 1)
        i = buf.find(_ZSTD_MAGIC, i + n)


def _save_chunk_index(path: str, params, source: str) -> None:
    """Write the chunk index of `params`, whose leaves the zstd frames of
    the files under `source` hold (a directory, stored relative to the
    index's own). The same tree and source always give the same bytes."""
    leaves: list = []
    index = _flatten(params, "", leaves)
    doc = {"source": os.path.relpath(source, os.path.dirname(os.path.abspath(path))),
           "tree": index,
           "leaves": {k: {"shape": list(a.shape), "sha256": hashlib.sha256(
               np.ascontiguousarray(a).tobytes()).hexdigest()} for k, a in leaves}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=0)
        f.write("\n")


def _load_chunk_index(path: str) -> dict:
    """Read the tree a `_save_chunk_index` file names from its source's
    zstd frames, every leaf a numpy array of its dtype and shape."""
    with open(path) as f:
        doc = json.load(f)
    source = os.path.join(os.path.dirname(os.path.abspath(path)), doc["source"])
    frames: dict = {}
    for d, _, files in sorted(os.walk(source)):
        for name in sorted(files):
            with open(os.path.join(d, name), "rb") as f:
                _zstd_frames(f.read(), frames)

    def leaf(e):
        meta = doc["leaves"][e["leaf"]]
        data = frames.get(meta["sha256"])
        if data is None:
            raise ValueError(f"{path}: no single zstd frame under {source} "
                             f"holds {e['leaf']}")
        dtype = np.uint16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
        arr = np.frombuffer(data, dtype).reshape(meta["shape"]).copy()
        return _as_dtype(arr, e["dtype"])

    return _unflatten(doc["tree"], leaf)
