"""Reader of HF model directories in the safetensors format, without the
`safetensors` or `transformers` packages.

A safetensors file is an 8-byte little-endian header length, a JSON header
(name -> dtype, shape, [begin, end) byte offsets into the data that
follows; an optional `__metadata__` entry), then the raw little-endian
tensor bytes. An HF directory holds one `model.safetensors` or shards named
by `model.safetensors.index.json`'s `weight_map`. The tensors keep the
file's names and dtypes (bfloat16 included), so the state dict equals the
one `AutoModelForCausalLM.from_pretrained(path, dtype="auto").state_dict()`
gives for the weights stored in the files, which is what
`utils.checkpoint.convert_hf_qwen2` takes.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Dict

import torch

_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64,
}

SINGLE = "model.safetensors"
INDEX = "model.safetensors.index.json"


def read_file(path: str) -> Dict[str, torch.Tensor]:
    """One safetensors file -> {name: CPU tensor}. The tensors are views of
    one buffer that holds the file's data."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host is not")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated safetensors file")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: bad offsets for {name}")
        t = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """An HF model directory's weights: the shards its index names, or its
    single `model.safetensors`."""
    index = os.path.join(path, INDEX)
    if os.path.isfile(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    elif os.path.isfile(os.path.join(path, SINGLE)):
        files = [SINGLE]
    else:
        raise FileNotFoundError(f"{path}: neither {SINGLE} nor {INDEX}")
    sd: Dict[str, torch.Tensor] = {}
    for name in files:
        sd.update(read_file(os.path.join(path, name)))
    return sd
