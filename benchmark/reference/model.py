"""Plain PyTorch reference of Freeze-Omni's dialog-state step, in float32
with TF32 off: the chunk-streaming speech encoder (Conv2dSubsampling4, a
pre-LN transformer with Transformer-XL relative attention over a sliding
window), the two-stage CNN adapter, the Qwen2 decoder and the 4-way state
head (softmax over the first three).

It follows the published architecture as the port documents it and
imports nothing of the port. The configuration's precisions are derived
here from the float weights the benchmark hands to both sides: weight-only
int8 (one scale per output channel) or grouped int4 (one scale per
`group` input rows and output channel) projections, the int8 per-row
embedding, and the int8 KV cache (one scale per token and kv head),
rounding half to even as the configuration states. The role prompt is
prefilled with float keys and values, then quantised like every later
token.

The decoder runs layer by layer over each call's whole token sequence.
With every cached key and value quantised per token, attention over the
cache tick by tick equals causal attention over the sequence, so the
ticks' grouping leaves the result unchanged; only the order of tokens
counts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def plain_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# quantisers (the configuration's rules)
# --------------------------------------------------------------------------

def int8_columns(w: torch.Tensor) -> torch.Tensor:
    """[in, out] -> dequantised f32 of weight-only int8, scale per column."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def int_groups(w: torch.Tensor, group: int, bits: int = 4) -> torch.Tensor:
    """[in, out] -> dequantised f32 of grouped symmetric `bits`-bit
    weights (int4: -7..7; int3, the control below it: -3..3)."""
    top = float(2 ** (bits - 1) - 1)
    w = w.float()
    K, O = w.shape
    wg = w.reshape(K // group, group, O)
    scale = torch.clamp(wg.abs().amax(dim=1, keepdim=True) / top, min=1e-8)
    return (torch.clamp(torch.round(wg / scale), -top, top) * scale).reshape(K, O)


def weight_q(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    return int8_columns(w) if bits == 8 else int_groups(w, group, bits)


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Activations through float8 e4m3 with one scale a row (amax / 448),
    dequantised: the control's precision below bfloat16."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def kv_q(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-vector quantisation over the head dim, dequantised."""
    top = 127.0 if bits == 8 else 7.0
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / top
    return torch.clamp(torch.round(x / s), -top, top) * s


# --------------------------------------------------------------------------
# encoder and adapter, streaming, batched over calls with an active mask
# --------------------------------------------------------------------------

def _ln(x, p, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _lin(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def sinusoidal(pos: torch.Tensor, d: int) -> torch.Tensor:
    inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
                    * -(math.log(10000.0) / d))
    ang = pos.float()[:, None] * inv[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(-1, d)


def _same(t):
    return t


def _chan(act):
    """act over the channel axis of a [B, C, ...] tensor."""
    return lambda t: act(t.movedim(1, -1)).movedim(-1, 1)


class Encoder:
    """One identity's streaming encoder state for B calls; `act` rounds
    the input of every linear and convolution (the control)."""

    def __init__(self, p: dict, cfg: dict, B: int, device, act=_same):
        self.p, self.cfg, self.act = p, cfg, act
        L, H, d = cfg["num_blocks"], cfg["attention_heads"], cfg["attention_dim"]
        self.cap = cfg["chunk_size"] * cfg["left_chunks"]
        self.k = torch.zeros(L, B, self.cap, H, d // H, device=device)
        self.v = torch.zeros_like(self.k)
        self.valid = torch.zeros(B, dtype=torch.long, device=device)
        self.pe = torch.zeros(B, dtype=torch.long, device=device)

    def step(self, xs: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        p, cfg = self.p, self.cfg
        H, d = cfg["attention_heads"], cfg["attention_dim"]
        dk = d // H
        a = self.act
        lin = lambda q, t: _lin(q, a(t))  # noqa: E731
        x = (xs - p["cmvn"]["mean"]) * p["cmvn"]["istd"]
        x = F.relu(F.conv2d(a(x[:, None]), p["sub"]["conv1"]["w"],
                            p["sub"]["conv1"]["b"], stride=2))
        x = F.relu(F.conv2d(_chan(a)(x), p["sub"]["conv2"]["w"],
                            p["sub"]["conv2"]["b"], stride=2))
        b, c, t, f = x.shape
        x = lin(p["sub"]["out"], x.permute(0, 2, 1, 3).reshape(b, t, c * f))
        x = F.relu(_ln(lin(p["embed"]["lin"], x), p["embed"]["ln"]))
        x = x * math.sqrt(d)
        B, T, _ = x.shape
        cap, S = self.cap, self.cap + T
        full = cfg["chunk_size"] * (cfg["left_chunks"] + 1)
        wrap = cfg["chunk_size"] * (cfg["pe_max_len"] // cfg["chunk_size"]) - full
        valid = torch.clamp(self.valid, max=cap)
        pe_idx = torch.remainder(self.pe, wrap)
        start = torch.clamp(pe_idx - full, min=0)
        slot = torch.arange(S, device=x.device)[None]
        pos = start[:, None] + slot - (cap - valid)[:, None]
        pos_emb = sinusoidal(pos.reshape(-1), d).reshape(B, S, d)
        keep = (slot >= (cap - valid)[:, None])[:, None, None, :]
        blocks = p["blocks"]
        new_k, new_v = [], []
        for i in range(cfg["num_blocks"]):
            bp = {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                      else v[i]) for k, v in blocks.items()}
            h = _ln(x, bp["ln1"])
            k_all = torch.cat([self.k[i], lin(bp["k"], h).reshape(B, T, H, dk)], 1)
            v_all = torch.cat([self.v[i], lin(bp["v"], h).reshape(B, T, H, dk)], 1)
            q = lin(bp["q"], h).reshape(B, T, H, dk)
            pp = (a(pos_emb) @ bp["pos"]["w"]).reshape(B, S, H, dk)
            ac = torch.einsum("bthd,bshd->bhts", q + bp["bias_u"], k_all)
            bd = torch.einsum("bthd,bshd->bhts", q + bp["bias_v"], pp)
            sc = torch.where(keep, (ac + bd) / math.sqrt(dk),
                             torch.full_like(ac, -1e9))
            att = torch.where(keep, torch.softmax(sc, -1), torch.zeros_like(sc))
            o = torch.einsum("bhts,bshd->bthd", att, v_all).reshape(B, T, d)
            x = x + lin(bp["o"], o)
            h2 = _ln(x, bp["ln2"])
            x = x + lin(bp["ffn2"], F.relu(lin(bp["ffn1"], h2)))
            new_k.append(k_all[:, -cap:])
            new_v.append(v_all[:, -cap:])
        x = _ln(x, p["after_norm"])
        a5 = active[None, :, None, None, None]
        self.k = torch.where(a5, torch.stack(new_k), self.k)
        self.v = torch.where(a5, torch.stack(new_v), self.v)
        self.valid = torch.where(active, torch.clamp(valid + T, max=cap), self.valid)
        self.pe = torch.where(active, pe_idx + cfg["chunk_size"], self.pe)
        return x


class Adapter:
    def __init__(self, p: dict, cfg: dict, B: int, device, act=_same):
        self.p, self.act = p, act
        k = cfg["kernel_size"] - 1
        C = cfg["enc_out_dim"]
        self.c1 = torch.zeros(B, C, k, device=device)
        self.c2 = torch.zeros(B, 2 * C, k, device=device)
        self.k = k

    @staticmethod
    def _bn(p, x):
        sh = (1, -1, 1)
        return ((x - p["mean"].reshape(sh)) * torch.rsqrt(p["var"].reshape(sh) + 1e-3)
                * p["scale"].reshape(sh) + p["bias"].reshape(sh))

    def step(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        p, a = self.p, _chan(self.act)
        full = torch.cat([self.c1, x.transpose(1, 2)], 2)
        c1 = full[:, :, -self.k:]
        y = F.relu(self._bn(p["bn1"], F.conv1d(a(full), p["conv1"]["w"],
                                               p["conv1"]["b"])))
        full2 = torch.cat([self.c2, y], 2)
        c2 = full2[:, :, -self.k:]
        y = F.relu(self._bn(p["bn2"], F.conv1d(a(full2), p["conv2"]["w"],
                                               p["conv2"]["b"], stride=2)))
        a3 = active[:, None, None]
        self.c1 = torch.where(a3, c1, self.c1)
        self.c2 = torch.where(a3, c2, self.c2)
        return _lin(p["proj"], self.act(y.transpose(1, 2)))


def activation_rounding(precision: dict):
    return fp8_rows if precision.get("activations") == "fp8" else _same


def audio_embeddings(p_enc: dict, p_adp: dict, dims: dict,
                     chunks: List[List[torch.Tensor]], device,
                     act=_same) -> List[torch.Tensor]:
    """chunks: per call, its submitted fbank windows ([32, 80]) of one
    identity in order. Returns per call [n_chunks, tokens, D]."""
    B = len(chunks)
    n = max((len(c) for c in chunks), default=0)
    enc = Encoder(p_enc, dims["encoder"], B, device, act)
    adp = Adapter(p_adp, dims["adapter"], B, device, act)
    outs: List[list] = [[] for _ in range(B)]
    shape = None
    for c in chunks:
        if c:
            shape = c[0].shape
            break
    for i in range(n):
        active = torch.tensor([i < len(c) for c in chunks], device=device)
        xs = torch.stack([c[i] if i < len(c) else torch.zeros(shape, device=device)
                          for c in chunks]).float()
        emb = adp.step(enc.step(xs, active), active)
        for b in range(B):
            if i < len(chunks[b]):
                outs[b].append(emb[b])
    return [torch.stack(o) if o else None for o in outs]


# --------------------------------------------------------------------------
# the decoder over whole calls, layer by layer
# --------------------------------------------------------------------------

def _rms(x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def _rope(x, pos, theta):
    dk = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dk, 2, dtype=torch.float32,
                                        device=x.device) / dk))
    f = pos.float()[:, None] * inv[None]
    emb = torch.cat([f, f], -1)
    cos, sin = torch.cos(emb)[:, None], torch.sin(emb)[:, None]
    rot = torch.cat([-x[..., dk // 2:], x[..., :dk // 2]], -1)
    return x * cos + rot * sin


def _attend(q, k, v, rep: int, causal_from: int):
    """q [T, H, dk] against k/v [S, Hkv, dk]; query t sees keys
    [0, causal_from + t]."""
    T, H, dk = q.shape
    S = k.shape[0]
    k = k.repeat_interleave(rep, 1)
    v = v.repeat_interleave(rep, 1)
    sc = torch.einsum("thd,shd->hts", q, k) / math.sqrt(dk)
    t = torch.arange(T, device=q.device)[:, None]
    s = torch.arange(S, device=q.device)[None]
    sc = torch.where(s <= causal_from + t, sc, torch.full_like(sc, float("-inf")))
    return torch.einsum("hts,shd->thd", torch.softmax(sc, -1), v)


def decode_calls(weights, dims: dict, precision: dict, role_ids: List[int],
                 calls: List[dict], device) -> List[torch.Tensor]:
    """calls: per call {'embeds': [T, D] f32 (prefix rows and audio rows in
    order), 'reads': [indices of the rows whose state is read]}. Returns
    per call [reads, 3] state probabilities."""
    m = dims["llm"]
    D, L = m["hidden"], m["num_layers"]
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    dk, rep = D // H, H // Hkv
    wb, kvb, group = precision["weight_bits"], precision["kv_bits"], precision["group"]
    act = activation_rounding(precision)
    eps, theta = m["rms_eps"], m["rope_theta"]
    emb_w = weights.get("llm/embed/w")
    ids = torch.tensor(role_ids, device=device)
    x_role = int8_rows(emb_w[ids])
    del emb_w
    R = x_role.shape[0]
    lens = [c["embeds"].shape[0] for c in calls]
    x = torch.cat([x_role] + [c["embeds"].float() for c in calls], 0)
    pos = torch.cat([torch.arange(R, device=device)]
                    + [R + torch.arange(n, device=device) for n in lens])
    bounds = [R]
    for n in lens:
        bounds.append(bounds[-1] + n)
    for li in range(L):
        def w(name):
            return weight_q(weights.get(f"llm/layers/{name}/w", li), wb, group)

        def b(name):
            return weights.get(f"llm/layers/{name}/b", li).float()

        ln1 = weights.get("llm/layers/ln1/scale", li).float()
        ln2 = weights.get("llm/layers/ln2/scale", li).float()
        h = act(_rms(x, eps) * ln1)
        q = _rope((h @ w("q") + b("q")).reshape(-1, H, dk), pos, theta)
        k = _rope((h @ w("k") + b("k")).reshape(-1, Hkv, dk), pos, theta)
        v = (h @ w("v") + b("v")).reshape(-1, Hkv, dk)
        att = torch.empty_like(q)
        att[:R] = _attend(q[:R], k[:R], v[:R], rep, 0)
        kq, vq = kv_q(k, kvb), kv_q(v, kvb)
        for c in range(len(calls)):
            a, z = bounds[c], bounds[c + 1]
            kk = torch.cat([kq[:R], kq[a:z]], 0)
            vv = torch.cat([vq[:R], vq[a:z]], 0)
            att[a:z] = _attend(q[a:z], kk, vv, rep, R)
        x = x + act(att.reshape(-1, D)) @ w("o")
        h2 = act(_rms(x, eps) * ln2)
        x = x + act(F.silu(h2 @ w("gate")) * (h2 @ w("up"))) @ w("down")
    x = _rms(x, eps) * weights.get("llm/final_norm/scale").float()
    pw, pb = weights.get("predictor/w"), weights.get("predictor/b")
    out = []
    for c in range(len(calls)):
        rows = x[bounds[c]:bounds[c + 1]][torch.tensor(calls[c]["reads"],
                                                       dtype=torch.long,
                                                       device=device)]
        out.append(torch.softmax((rows @ pw + pb)[:, :-1], -1))
    return out


def prefix_embeddings(weights, ids: List[int], device) -> torch.Tensor:
    emb_w = weights.get("llm/embed/w")
    return int8_rows(emb_w[torch.tensor(ids, device=device)])
