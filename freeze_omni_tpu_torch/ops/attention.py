"""K2: int8-KV chunk-prefill attention (counterpart of
freeze_omni_tpu/ops/attention.py:prefill_quant_pallas and its dispatcher
prefill_quant).

The serving tick's LLM pass is a chunk prefill of T queries per session
against the session's int8 cache. Query t of row b sees slots
[0, qend[b, t]); qend = 0 marks an invalid query. The per-token, per-kv-head
scales factor out of the dots: k_scale multiplies the scores and v_scale
folds into the softmax weights.

`prefill_quant` launches the hand-written Hopper kernel in
csrc/prefill_quant.cu for CUDA tensors and runs `prefill_quant_reference`,
the plain PyTorch version of the same f32 arithmetic, for CPU tensors only.
A CUDA tensor the kernel does not take raises. Rows with qend = 0 come out
as zeros in both (the JAX versions leave them unspecified).
`prefill_quant.launches` counts kernel launches.

The decode kernels of the JAX module (decode_attention,
decode_attention_blocked) belong to the response path and are not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def prefill_quant_reference(q, k_q, k_scale, v_q, v_scale, qend):
    """q: [B,T,H,dk]; k_q/v_q: [B,S,Hkv,dk] int8; k_scale/v_scale: [B,S,Hkv]
    f32; qend: [B,T] int. Returns [B,T,H,dk] in q.dtype. Masked slots are
    removed by selection, so a non-finite scale in a masked slot (the scratch
    slot S-1) cannot reach the result."""
    B, T, H, dk = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    rep = H // Hkv
    qg = q.float().reshape(B, T, Hkv, rep, dk)
    ks = k_scale.float().permute(0, 2, 1)[:, :, None, None, :]  # [B,Hkv,1,1,S]
    vs = v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    scores = torch.einsum("bthrd,bshd->bhrts", qg, k_q.float())
    scores = scores * ks * (1.0 / math.sqrt(dk))
    slot = torch.arange(S, device=q.device)
    mask = (slot[None, None, :] < qend[:, :, None])[:, None, None]  # [B,1,1,T,S]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    pv = torch.where(mask, p * vs, torch.zeros_like(p))
    out = torch.einsum("bhrts,bshd->bthrd", pv, v_q.float())
    return out.reshape(B, T, H, dk).to(q.dtype)


def _lib():
    fn = _build.load("prefill_quant").prefill_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k_q, k_scale, v_q, v_scale, qend) -> None:
    dev = q.device
    for name, t in (("k_q", k_q), ("k_scale", k_scale), ("v_q", v_q),
                    ("v_scale", v_scale), ("qend", qend)):
        if t.device != dev:
            raise ValueError(f"prefill_quant: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"prefill_quant: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("prefill_quant: q must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"prefill_quant: q dtype {q.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError("prefill_quant: k_q and v_q must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("prefill_quant: scales must be float32")
    if qend.dtype != torch.int32:
        raise TypeError(f"prefill_quant: qend must be int32, got {qend.dtype}")
    if q.dim() != 4 or k_q.dim() != 4:
        raise ValueError("prefill_quant: want q [B,T,H,dk] and k_q [B,S,Hkv,dk]")
    B, T, H, dk = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    if (k_q.shape != (B, S, Hkv, dk) or v_q.shape != k_q.shape
            or k_scale.shape != (B, S, Hkv) or v_scale.shape != (B, S, Hkv)
            or qend.shape != (B, T)):
        raise ValueError(
            f"prefill_quant: inconsistent shapes q {tuple(q.shape)}, k_q "
            f"{tuple(k_q.shape)}, v_q {tuple(v_q.shape)}, k_scale "
            f"{tuple(k_scale.shape)}, v_scale {tuple(v_scale.shape)}, qend "
            f"{tuple(qend.shape)}")
    if dk not in _HEAD_DIMS or H % Hkv:
        raise ValueError(f"prefill_quant: head_dim {dk} not in {_HEAD_DIMS} "
                         f"or H={H} not a multiple of Hkv={Hkv}")
    if k_q.data_ptr() % 4 or v_q.data_ptr() % 4:
        raise ValueError("prefill_quant: k_q/v_q must be 4-byte aligned")


def prefill_quant(q, k_q, k_scale, v_q, v_scale, qend):
    """Same contract as prefill_quant_reference."""
    if q.device.type == "cpu":
        return prefill_quant_reference(q, k_q, k_scale, v_q, v_scale, qend)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_quant: unsupported device {q.device}")
    _check_cuda_args(q, k_q, k_scale, v_q, v_scale, qend)
    B, T, H, dk = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_q.data_ptr(),
                 k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
                 qend.data_ptr(), out.data_ptr(), B, T, H, Hkv, S, dk, stream)
    _build.check(err, "prefill_quant")
    prefill_quant.launches += 1
    return out


prefill_quant.launches = 0
