"""The yardstick's arithmetic: the card's peaks, the operations and bytes a
kernel's inputs need, the model FLOPs of a served token, and which of the
port's kernels a device event belongs to.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, as the
port's measurement scripts use them: 989 TFLOP/s dense bf16 on the tensor
cores and 3.35 TB/s of HBM. A bound counts each input byte once and each
output byte once, for the rows and cache slots the inputs need (padding
rows and slots past a row's valid length are not counted).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES, flops / BF16_FLOPS)


def linear_bound(v: int, K: int, O: int, bits: int, group: int) -> float:
    """One weight-only projection of v valid bf16 rows: the weights once
    (int8: a byte; int4: half a byte, plus one f32 scale per group and
    column), the rows in and out in bf16."""
    if v <= 0:
        return 0.0
    if bits == 8:
        wbytes = K * O + 4 * O
    else:
        wbytes = K * O / 2 + 4 * (K // group) * O
    return bound_s(wbytes + 2 * v * K + 2 * v * O, 2.0 * v * K * O)


def k2_bound(rows: Iterable[Tuple[int, List[int]]], H: int, Hkv: int,
             dk: int) -> float:
    """One int8-KV prefill attention call. rows: per batch row, the
    visible-slot count of each valid query (qend). Reads each row's K and V
    codes and scales up to its longest qend once, q in and out in bf16;
    QK^T and PV over the visible slots."""
    nbytes = 0.0
    flops = 0.0
    for _, qends in rows:
        if not qends:
            continue
        s = max(qends)
        nbytes += s * Hkv * (2 * dk + 2 * 4) + len(qends) * H * dk * 2 * 2
        flops += 4.0 * H * dk * sum(qends)
    return bound_s(nbytes, flops)


def llm_linear_params(llm: dict) -> int:
    D, F, L = llm["hidden"], llm["ffn"], llm["num_layers"]
    dk = D // llm["num_heads"]
    q, kv = llm["num_heads"] * dk, llm["num_kv_heads"] * dk
    return L * (D * q + 2 * D * kv + q * D + 3 * D * F)


def encoder_flops(enc: dict, t_in: int) -> float:
    """One chunk of t_in fbank frames through the streaming encoder."""
    d, H, U, L = (enc["attention_dim"], enc["attention_heads"],
                  enc["linear_units"], enc["num_blocks"])
    f1 = (enc["input_dim"] - 1) // 2
    t1 = (t_in - 1) // 2
    f2, t2 = (f1 - 1) // 2, (t1 - 1) // 2
    flops = 2.0 * t1 * f1 * d * 9 + 2.0 * t2 * f2 * d * d * 9
    flops += 2.0 * t2 * (d * f2) * d + 2.0 * t2 * d * d
    S = enc["chunk_size"] * enc["left_chunks"] + t2
    per_block = 2.0 * t2 * d * d * 4 + 2.0 * S * d * d + 2.0 * t2 * S * d * 3 \
        + 2.0 * t2 * d * U * 2
    return flops + L * per_block


def adapter_flops(adp: dict, t_enc: int) -> float:
    C, k, D = adp["enc_out_dim"], adp["kernel_size"], adp["llm_dim"]
    t_out = (t_enc + 1) // 2
    return 2.0 * t_enc * (2 * C) * C * k + 2.0 * t_out * (4 * C) * (2 * C) * k \
        + 2.0 * t_out * 4 * C * D


# --------------------------------------------------------------------------
# kernel names
# --------------------------------------------------------------------------

FAMILIES = {
    "k1": ("W8Tile", "w8a32_simt_kernel"),
    "k5": ("W4Tile", "w4a32_simt_kernel", "w4_small_kernel",
           "w4a16_small_mma_kernel"),
    "k2": ("prefill_tc_kernel", "prefill_merge_kernel", "prefill_quant_kernel"),
}


def family(name: str, previous: Optional[str]) -> Optional[str]:
    """The port kernel a device event belongs to. The tile path's
    split_sum_kernel sums the partials of the tile kernel launched just
    before it on the stream, so it takes that kernel's family."""
    for fam, keys in FAMILIES.items():
        if any(k in name for k in keys):
            return fam
    if "split_sum_kernel" in name:
        return previous
    return None


def family_seconds(device_ops) -> dict:
    """{family: device seconds} over [(name, start_s, end_s)] in start
    order."""
    out: dict = {}
    prev = None
    for name, s, e in device_ops:
        fam = family(name, prev)
        if fam is not None:
            out[fam] = out.get(fam, 0.0) + (e - s)
            if "split_sum_kernel" not in name:
                prev = fam
        elif "wonly_tile_kernel" not in name:
            prev = None
    return out
