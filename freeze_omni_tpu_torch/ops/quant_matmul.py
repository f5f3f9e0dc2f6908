"""K1: weight-only int8 matmul (counterpart of freeze_omni_tpu/ops/quant_matmul.py:quant_matmul).

    y[N, O] = x[N, K] @ (w_q[K, O] * scale[O])    f32 accumulation, y in x.dtype

`quant_matmul` launches the hand-written Hopper kernel in
csrc/quant_matmul.cu for CUDA tensors (bf16 activations on the tensor cores,
f32 activations on f32 FMAs) and runs `quant_matmul_reference`, the plain
PyTorch version of the same arithmetic, for CPU tensors only. A CUDA tensor
the kernel does not take raises; it never falls back to the plain version.
N and O may be ragged (any N >= 1): the kernel masks the edges instead of
padding. `quant_matmul.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quant_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize in f32, f32 product, cast to x.dtype."""
    w = w_q.float() * scale.float()[None, :]
    return torch.matmul(x.float(), w).to(x.dtype)


def _lib():
    lib = _build.load("quant_matmul")
    fn = lib.quant_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(x, w_q, scale) -> None:
    dev = x.device
    if w_q.device != dev or scale.device != dev:
        raise ValueError(f"quant_matmul: tensors on different devices "
                         f"({dev}, {w_q.device}, {scale.device})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quant_matmul: x dtype {x.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: w_q must be int8 and scale float32, "
                        f"got {w_q.dtype} and {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"quant_matmul: want x [N,K], w_q [K,O], scale [O]; "
                         f"got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    if x.shape[1] != w_q.shape[0] or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"quant_matmul: shape mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} with scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("quant_matmul: x, w_q and scale must be contiguous")


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x: [N, K] bf16/f32; w_q: [K, O] int8; scale: [O] f32 -> [N, O] x.dtype."""
    if x.device.type == "cpu":
        return quant_matmul_reference(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    _check_cuda_args(x, w_q, scale)
    N, K = x.shape
    O = w_q.shape[1]
    y = torch.empty((N, O), dtype=x.dtype, device=x.device)
    if N == 0 or O == 0:
        return y
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w_q.data_ptr(),
                 scale.data_ptr(), y.data_ptr(), N, K, O, stream)
    _build.check(err, "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0
