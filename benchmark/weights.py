"""Seeded float weights, made on the device, that the benchmark hands to
both the program and its reference.

Every leaf (and every layer of a stacked leaf) draws from its own
`torch.Generator`, seeded from a hash of (seed, path, layer), so the
reference can draw one layer of one leaf again without the others. The
distributions are torch's defaults (kaiming-uniform bounds) and N(0, 0.02)
for embeddings; norms start at ones and zeros, as the port's initialisers
draw them.

The tree has the port's layouts (linear weights [in, out], convolutions
[out, in, k...], layer leaves stacked [L, ...]), because those are the
program's input format; `LLM_PROJ` lists the quantised projections.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch

LLM_PROJ = ("q", "k", "v", "o", "gate", "up", "down")


def _leaf_seed(seed: int, path: str, layer: int) -> int:
    h = hashlib.sha256(f"{int(seed)}/{path}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(seed: int, path: str, shape, init: tuple, device, layer: int = -1,
         dtype=torch.float32) -> torch.Tensor:
    kind = init[0]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path, layer))
    if kind == "uniform":
        t = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
        t = (t * 2.0 - 1.0) * init[1]
    elif kind == "normal":
        t = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32) * init[1]
    else:
        raise ValueError(f"unknown init {init!r}")
    return t.to(dtype)


def _lin(path, i, o, bias=True, stack=None, dtype="f32"):
    b = 1.0 / math.sqrt(i)
    out = [(f"{path}/w", (i, o), ("uniform", b), stack, dtype)]
    if bias:
        out.append((f"{path}/b", (o,), ("uniform", b), stack, dtype))
    return out


def _norm(path, d, stack=None, bias=True, dtype="f32"):
    out = [(f"{path}/scale", (d,), ("ones",), stack, dtype)]
    if bias:
        out.append((f"{path}/bias", (d,), ("zeros",), stack, dtype))
    return out


def spec(dims: dict) -> list:
    """[(path, shape, init, layers stacked or None, dtype)] of every leaf."""
    e, a, m = dims["encoder"], dims["adapter"], dims["llm"]
    d, H = e["attention_dim"], e["attention_heads"]
    L = e["num_blocks"]
    f_sub = ((e["input_dim"] - 1) // 2 - 1) // 2
    out = []
    for ident in ("user", "system"):
        p = f"encoder_{ident}"
        b1 = 1.0 / math.sqrt(9)
        b2 = 1.0 / math.sqrt(d * 9)
        out += [(f"{p}/sub/conv1/w", (d, 1, 3, 3), ("uniform", b1), None, "f32"),
                (f"{p}/sub/conv1/b", (d,), ("uniform", b1), None, "f32"),
                (f"{p}/sub/conv2/w", (d, d, 3, 3), ("uniform", b2), None, "f32"),
                (f"{p}/sub/conv2/b", (d,), ("uniform", b2), None, "f32")]
        out += _lin(f"{p}/sub/out", d * f_sub, d)
        out += _lin(f"{p}/embed/lin", d, d) + _norm(f"{p}/embed/ln", d)
        bp = f"{p}/blocks"
        out += _norm(f"{bp}/ln1", d, L) + _norm(f"{bp}/ln2", d, L)
        for n in ("q", "k", "v", "o"):
            out += _lin(f"{bp}/{n}", d, d, stack=L)
        out += _lin(f"{bp}/pos", d, d, bias=False, stack=L)
        bu = math.sqrt(6.0 / (d + d // H))
        out += [(f"{bp}/bias_u", (H, d // H), ("uniform", bu), L, "f32"),
                (f"{bp}/bias_v", (H, d // H), ("uniform", bu), L, "f32")]
        out += _lin(f"{bp}/ffn1", d, e["linear_units"], stack=L)
        out += _lin(f"{bp}/ffn2", e["linear_units"], d, stack=L)
        out += _norm(f"{p}/after_norm", d)
        out += [(f"{p}/cmvn/mean", (e["input_dim"],), ("zeros",), None, "f32"),
                (f"{p}/cmvn/istd", (e["input_dim"],), ("ones",), None, "f32")]
        q = f"adapter_{ident}"
        C, k = a["enc_out_dim"], a["kernel_size"]
        for name, i, o in (("conv1", C, 2 * C), ("conv2", 2 * C, 4 * C)):
            bb = 1.0 / math.sqrt(i * k)
            out += [(f"{q}/{name}/w", (o, i, k), ("uniform", bb), None, "f32"),
                    (f"{q}/{name}/b", (o,), ("uniform", bb), None, "f32")]
            bn = f"{q}/bn{name[-1]}"
            out += [(f"{bn}/scale", (o,), ("ones",), None, "f32"),
                    (f"{bn}/bias", (o,), ("zeros",), None, "f32"),
                    (f"{bn}/mean", (o,), ("zeros",), None, "f32"),
                    (f"{bn}/var", (o,), ("ones",), None, "f32")]
        out += _lin(f"{q}/proj", 4 * C, a["llm_dim"])
    D, Lm = m["hidden"], m["num_layers"]
    Hq, Hkv, dk = m["num_heads"], m["num_kv_heads"], m["hidden"] // m["num_heads"]
    F = m["ffn"]
    out += [("llm/embed/w", (m["vocab_size"], D), ("normal", 0.02), None, "bf16")]
    out += _norm("llm/layers/ln1", D, Lm, bias=False, dtype="bf16")
    out += _norm("llm/layers/ln2", D, Lm, bias=False, dtype="bf16")
    for n, i, o, bias in (("q", D, Hq * dk, True), ("k", D, Hkv * dk, True),
                          ("v", D, Hkv * dk, True), ("o", Hq * dk, D, False),
                          ("gate", D, F, False), ("up", D, F, False),
                          ("down", F, D, False)):
        out += _lin(f"llm/layers/{n}", i, o, bias=bias, stack=Lm, dtype="bf16")
    out += _norm("llm/final_norm", D, bias=False, dtype="bf16")
    out += [("llm/lm_head/w", (D, m["vocab_size"]), ("normal", 0.02), None, "bf16")]
    out += _lin("predictor", D, dims["num_states"])
    out += [("task_embeddings", (dims["task_num"], D), ("normal", 0.02), None,
             "f32")]
    return out


_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


class Weights:
    """The seeded leaves of one configuration on one device."""

    def __init__(self, dims: dict, seed: int, device):
        self.seed, self.device = int(seed), device
        self.leaves = {p: (shape, init, stack, _DT[dt])
                       for p, shape, init, stack, dt in spec(dims)}

    def get(self, path: str, layer: int = -1) -> torch.Tensor:
        """A leaf, or one layer of a stacked leaf (layer >= 0)."""
        shape, init, stack, dt = self.leaves[path]
        if stack is not None and layer < 0:
            out = torch.empty((stack, *shape), dtype=dt, device=self.device)
            for i in range(stack):
                out[i] = draw(self.seed, path, shape, init, self.device, i, dt)
            return out
        return draw(self.seed, path, shape, init, self.device, layer, dt)

    def items(self, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
        for p in self.leaves:
            if p.startswith(prefix):
                yield p, self.get(p)

    def stack_of(self, path: str) -> int:
        return self.leaves[path][2]


def nest(flat: Dict[str, torch.Tensor], strip: str = "") -> dict:
    """{'a/b/c': t} -> {'a': {'b': {'c': t}}}, with `strip` cut off the front."""
    out: dict = {}
    for path, t in flat.items():
        parts = path[len(strip):].split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return out
