"""Weight-only quantized matmuls (counterpart of
freeze_omni_tpu/ops/quant_matmul.py):

K1  quant_matmul:  y[N, O] = x[N, K] @ (w_q[K, O] * scale[O])
K5  quant_matmul4: y[N, O] = x[N, K] @ W, W[k, o] = (nibble(w_q4[k // 2, o],
    k % 2) - 8) * scale4[k // group, o]; row 2i is the low nibble, 2i+1 the
    high one (ops/quant.quantize_linear_int4)

f32 accumulation, y in x.dtype. Each wrapper launches its hand-written Hopper
kernel (csrc/quant_matmul.cu, csrc/quant_matmul4.cu) for CUDA tensors (bf16
activations on the tensor cores, f32 activations on f32 FMAs) and runs its
`*_reference`, the plain PyTorch version of the same arithmetic, for CPU
tensors only. A CUDA tensor the kernel does not take raises; it never falls
back to the plain version. N and O may be ragged (any N >= 1): the kernels
mask the edges instead of padding. `quant_matmul.launches` and
`quant_matmul4.launches` count kernel launches.
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


def quant_matmul4_reference(x: torch.Tensor, w_q4: torch.Tensor,
                            scale4: torch.Tensor, group: int) -> torch.Tensor:
    """Plain version: dequantize the nibbles in f32, f32 product, cast to
    x.dtype."""
    from .quant import dequantize_weight_int4

    if scale4.shape[0] * group != 2 * w_q4.shape[0]:
        raise ValueError(f"quant_matmul4: group {group} does not match w_q4 "
                         f"{tuple(w_q4.shape)} and scale4 {tuple(scale4.shape)}")
    w = dequantize_weight_int4({"w_q4": w_q4, "scale4": scale4.float()},
                               dtype=torch.float32)
    return torch.matmul(x.float(), w).to(x.dtype)


def _lib(name: str, n_ints: int):
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * n_ints + [ctypes.c_void_p]
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
    fn = _lib("quant_matmul", 3)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w_q.data_ptr(),
                 scale.data_ptr(), y.data_ptr(), N, K, O, stream)
    _build.check(err, "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


def _check_cuda_args4(x, w_q4, scale4, group) -> None:
    dev = x.device
    if w_q4.device != dev or scale4.device != dev:
        raise ValueError(f"quant_matmul4: tensors on different devices "
                         f"({dev}, {w_q4.device}, {scale4.device})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quant_matmul4: x dtype {x.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if w_q4.dtype != torch.uint8 or scale4.dtype != torch.float32:
        raise TypeError(f"quant_matmul4: w_q4 must be uint8 and scale4 float32, "
                        f"got {w_q4.dtype} and {scale4.dtype}")
    if x.dim() != 2 or w_q4.dim() != 2 or scale4.dim() != 2:
        raise ValueError(f"quant_matmul4: want x [N,K], w_q4 [K/2,O], scale4 "
                         f"[K/group,O]; got {tuple(x.shape)}, "
                         f"{tuple(w_q4.shape)}, {tuple(scale4.shape)}")
    K = x.shape[1]
    if K != 2 * w_q4.shape[0] or scale4.shape[1] != w_q4.shape[1]:
        raise ValueError(f"quant_matmul4: shape mismatch {tuple(x.shape)} @ "
                         f"{tuple(w_q4.shape)} with scale4 {tuple(scale4.shape)}")
    if group <= 0 or group % 2 or scale4.shape[0] * group != K:
        raise ValueError(f"quant_matmul4: group {group} must be even and "
                         f"cover K={K} in {scale4.shape[0]} scale rows")
    if not (x.is_contiguous() and w_q4.is_contiguous()
            and scale4.is_contiguous()):
        raise ValueError("quant_matmul4: x, w_q4 and scale4 must be contiguous")


def quant_matmul4(x: torch.Tensor, w_q4: torch.Tensor, scale4: torch.Tensor,
                  group: int) -> torch.Tensor:
    """x: [N, K] bf16/f32; w_q4: [K/2, O] uint8; scale4: [K/group, O] f32
    -> [N, O] x.dtype."""
    if x.device.type == "cpu":
        return quant_matmul4_reference(x, w_q4, scale4, group)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul4: unsupported device {x.device}")
    _check_cuda_args4(x, w_q4, scale4, group)
    N, K = x.shape
    O = w_q4.shape[1]
    y = torch.empty((N, O), dtype=x.dtype, device=x.device)
    if N == 0 or O == 0:
        return y
    fn = _lib("quant_matmul4", 4)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w_q4.data_ptr(),
                 scale4.data_ptr(), y.data_ptr(), N, K, O, group, stream)
    _build.check(err, "quant_matmul4")
    quant_matmul4.launches += 1
    return y


quant_matmul4.launches = 0
