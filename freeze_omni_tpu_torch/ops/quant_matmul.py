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

bf16 activations take the tile path (csrc/wonly_tile.cuh), one mma.sync
mainloop that K1 and K5 share: `tile_plan` picks its warp tiling and its K
splits, and a float32 workspace of [splits, N, O], kept per card and
stream, holds the partials that a second, small kernel sums in a fixed
order. K1 takes it at every N. K5 has a second path: N <= SMALL_N (a
text-decode step) is bound by the weight bytes and takes the split-K
small-N path planned by `small_plan`; larger N (the tick) takes the tile
path. `quant_matmul4.launches_small` counts the small path's launches, and
`quant_matmul4.launches` both paths'.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

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
    """The tile launch function of kernel `name`: (dtype, x, w, scale, y,
    ws, n_ints ints, stream)."""
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
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
    if not x.is_cuda:
        if x.device.type == "cpu":
            return quant_matmul_reference(x, w_q, scale)
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    dev = x.get_device()
    if dev != torch.cuda.current_device():   # launch on x's card
        with torch.cuda.device(dev):
            return quant_matmul(x, w_q, scale)
    _check_cuda_args(x, w_q, scale)
    N, K = x.shape
    O = w_q.shape[1]
    y = x.new_empty((N, O))
    if N == 0 or O == 0:
        return y
    stream = torch._C._cuda_getCurrentRawStream(dev)
    nt, wr, splits, kps = tile_plan(N, K, O)
    ws = _build.workspace(dev, stream, splits * N * O) \
        if splits > 1 and x.dtype == torch.bfloat16 else None
    err = _lib("quant_matmul", 7)(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                  w_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                  ws, N, K, O, nt, wr, splits, kps, stream)
    _build.check(err, "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


def _check_cuda_args4(x, w_q4, scale4, group) -> None:
    dev = x.get_device()
    if w_q4.get_device() != dev or scale4.get_device() != dev:
        raise ValueError(f"quant_matmul4: tensors on different devices "
                         f"({x.device}, {w_q4.device}, {scale4.device})")
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


# K5's small-N path: the largest N it takes (the kernel keeps up to 32 rows
# of accumulators in registers), and the largest N the dispatch sends it,
# set from the crossover measured on the card (PERF.md)
SMALL_N_MAX = 32
SMALL_N = 16
_WARP_COLS = 128              # output columns a warp of the split kernel
_X_SLICE_BYTES = 32 * 1024    # a block's x slice in shared memory, at most
_TARGET_WARPS = 132 * 8       # ~8 warps on each of the H100's 132 SMs
_MIN_BLOCKS = 2 * 132


def _rows_padded(N: int) -> int:
    """The kernel's row count for N rows: 4, 8, 16 or 32."""
    return 4 if N <= 4 else 8 if N <= 8 else 16 if N <= 16 else 32


@functools.lru_cache(maxsize=None)
def small_plan(N: int, K: int, O: int, group: int) -> Tuple[int, int]:
    """(warps a block, K splits) of K5's small-N launch. Each warp takes a
    128-column slab and each split a run of whole groups (split s covers
    groups [s * gps, (s + 1) * gps), gps = ceil(G / splits)). Splits are
    chosen so that slabs x splits is ~8 warps on each SM: many for the
    narrow (k, v) and the deep (down) shapes, few for gate/up and the
    lm_head, whose slabs already fill the card; a split's x slice must fit
    its shared memory. Warps a block drop from 4 to 2 or 1 while the grid
    would have fewer than 2 x 132 blocks."""
    G = K // group
    slabs = -(-O // _WARP_COLS)
    gps_max = max(1, _X_SLICE_BYTES // (group * _rows_padded(N) * 4))
    gps = min(gps_max, max(1, -(-G // -(-_TARGET_WARPS // slabs))))
    splits = -(-G // gps)
    warps = 4
    while warps > 1 and -(-slabs // warps) * splits < _MIN_BLOCKS:
        warps //= 2
    return warps, splits


# The tile path (csrc/wonly_tile.cuh): K steps of TILE_K k, TILE_STAGES of
# them in a block's shared-memory ring; 4 warps a block, each 64 output
# columns x 8 * nt rows
TILE_K = 64
TILE_STAGES = 4
_TILE_WARPS = 4
_X_ROW_BYTES = TILE_K * 2 + 16    # a staged x row, padded
SMEM_PER_BLOCK = 227 * 1024       # an H100 block's dynamic shared memory, at most
# the split partials of one tile-path call, at most: splits are added only
# while the grid has fewer than _MIN_BLOCKS tiles, so splits x tiles <
# 2 x _MIN_BLOCKS, and a tile holds at most 64 x 128 or 32 x 256 outputs
TILE_WORKSPACE_BYTES = 2 * _MIN_BLOCKS * 64 * 128 * 4


@functools.lru_cache(maxsize=None)
def tile_plan(N: int, K: int, O: int,
              group: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(nt, wr, splits, kps) of the tile path for x [N, K] @ W [K, O]: a
    warp takes nt n8 tiles of rows (8 * nt rows) and 64 columns, wr of the
    block's 4 warps stack along the rows and 4 // wr along the columns; K
    is cut into `splits` runs of `kps` K steps (the last may be shorter,
    none is empty). N <= 32 takes one warp row of 8, 16 or 32 rows and 256
    columns a block, larger N 2 x 2 warps (64 rows x 128 columns). Splits
    are added while the tile grid has fewer than 2 x 132 blocks, in whole
    K steps and, for K5 (`group` given), in whole groups."""
    nt = 1 if N <= 8 else 2 if N <= 16 else 4
    wr = 1 if N <= 32 else 2
    rows, cols = 8 * nt * wr, 64 * (_TILE_WARPS // wr)
    tiles = -(-N // rows) * -(-O // cols)
    steps = -(-K // TILE_K)
    unit = 1 if group is None else math.lcm(TILE_K, group) // TILE_K
    units = -(-steps // unit)
    splits = 1 if tiles >= _MIN_BLOCKS else min(units, -(-_MIN_BLOCKS // tiles))
    kps = -(-units // splits) * unit
    return nt, wr, -(-steps // kps), kps


def tile_smem_bytes(nt: int, wr: int, int4: bool) -> int:
    """Dynamic shared memory of a tile-path block (wonly_tile.cuh's
    tile_stage_bytes times the stages): the x tile, the weight tile (K1: 64
    int8 rows, K5: 32 packed rows, padded) and, for K5, up to 4 scale rows,
    per stage."""
    cols = 64 * (_TILE_WARPS // wr)
    stage = 8 * nt * wr * _X_ROW_BYTES
    if int4:
        stage += TILE_K // 2 * (cols + 32) + TILE_K // 16 * cols * 4
    else:
        stage += TILE_K * (cols + 16)
    return TILE_STAGES * stage


def takes_small_path(N: int, group: int) -> bool:
    """Whether quant_matmul4 sends N rows to the small-N path: N <= SMALL_N
    and one group's x slice fits a block's shared memory."""
    return 1 <= N <= SMALL_N and group * _rows_padded(N) * 4 <= _X_SLICE_BYTES


def quant_matmul4(x: torch.Tensor, w_q4: torch.Tensor, scale4: torch.Tensor,
                  group: int, path: Optional[str] = None) -> torch.Tensor:
    """x: [N, K] bf16/f32; w_q4: [K/2, O] uint8; scale4: [K/group, O] f32
    -> [N, O] x.dtype. path: None picks by N (takes_small_path); "small" or
    "tile" forces one on a CUDA tensor (to time both at one N)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return quant_matmul4_reference(x, w_q4, scale4, group)
        raise ValueError(f"quant_matmul4: unsupported device {x.device}")
    dev = x.get_device()
    if dev != torch.cuda.current_device():   # launch on x's card
        with torch.cuda.device(dev):
            return quant_matmul4(x, w_q4, scale4, group, path)
    _check_cuda_args4(x, w_q4, scale4, group)
    N, K = x.shape
    O = w_q4.shape[1]
    if path is None:
        small = takes_small_path(N, group)
    elif path in ("small", "tile"):
        small = path == "small"
    else:
        raise ValueError(f"quant_matmul4: path {path!r} not in small, tile")
    if small and not 1 <= N <= SMALL_N_MAX:
        raise ValueError(f"quant_matmul4: the small-N path takes 1 to "
                         f"{SMALL_N_MAX} rows, got {N}")
    y = x.new_empty((N, O))
    if N == 0 or O == 0:
        return y
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if small:
        warps, splits = small_plan(N, K, O, group)
        err = _small_lib()(_DTYPE_CODE[x.dtype], x.data_ptr(), w_q4.data_ptr(),
                           scale4.data_ptr(), y.data_ptr(),
                           _build.workspace(dev, stream, splits * N * O), N, K, O,
                           group, warps, splits, stream)
    else:
        bf16 = x.dtype == torch.bfloat16
        if bf16 and group % 16:
            raise ValueError(f"quant_matmul4: the tile path takes bf16 groups "
                             f"of whole 16-row K steps, got group {group}")
        nt, wr, splits, kps = tile_plan(N, K, O, group)
        ws = _build.workspace(dev, stream, splits * N * O) \
            if splits > 1 and bf16 else None
        err = _lib("quant_matmul4", 8)(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w_q4.data_ptr(),
            scale4.data_ptr(), y.data_ptr(), ws, N, K, O, group, nt, wr,
            splits, kps, stream)
    _build.check(err, "quant_matmul4")
    quant_matmul4.launches += 1
    quant_matmul4.launches_small += small
    return y


_small_fn = None


def _small_lib():
    global _small_fn
    if _small_fn is None:
        fn = _build.load("quant_matmul4").quant_matmul4_small_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _small_fn = fn
    return _small_fn


quant_matmul4.launches = 0
quant_matmul4.launches_small = 0
