// K5: grouped int4 weight-only matmul,
//   y[N,O] = sum_k x[N,k] * (nibble(w_q4[k/2, o], k%2) - 8) * scale4[k/group, o]
// where row 2i of the unpacked weight is the low nibble of packed row i and
// row 2i+1 the high nibble (ops/quant.quantize_linear_int4).
//
// Replaces the TPU kernel freeze_omni_tpu/ops/quant_matmul.py:quant_matmul4
// (body _kernel4). Built for sm_90a by ops/_build.py and bound with ctypes
// (ops/quant_matmul.py).
//
// What bounds it on an H100: the call moves K*O/2 packed weight bytes and
// (K/group)*O*4 scale bytes once and does 2*N*K*O operations. At the serving
// tick (N = 232: 8 sessions x 29 tokens) it is bound by operations (one
// layer's 7 projections: 108 GFLOP, 0.109 ms at 989 TFLOP/s against 0.035
// ms of bytes); at a text-decode step (N = 8) by the weight bytes. Nibbles
// are read as unsigned bytes, so the value nibble - 8 spans -8..7 (the
// quantizer never writes nibble 0, -8, but the kernels compute it). Ragged
// N and O are masked, not padded.
//
// Two paths for bf16 activations, chosen by the wrapper
// (ops/quant_matmul.quant_matmul4) from N:
//
// - N > SMALL_N (the tick): the tile path, the mma.sync mainloop that K1
//   shares (wonly_tile.cuh) with K5's weight policy W4Tile below: a
//   4-stage cp.async ring of x and packed weight tiles, so three K steps
//   are in flight while one is summed; the packed bytes unpacked in
//   registers into exact bf16 pairs and scaled by their group's scale as a
//   bf16 pair before the mma; split-K in whole groups (ops/quant_matmul.
//   tile_plan) where the tile grid is under two waves of 132 SMs (q, k, v, o
//   and down at N = 232). Groups must be whole 16-row K steps.
// - N <= SMALL_N (text decode, N = sessions speaking, 1-8): bound by bytes,
//   the packed weights and the scales, which every output row shares. The
//   small-N path (w4_small_kernel, w4a16_small_mma_kernel):
//   * reads every packed byte and every scale once, with 16-byte cp.async
//     loads of packed rows: lane l of a warp takes 4 columns of a 128-column
//     slab, and the warp stages up to 32 packed rows of its slab (4 KB) in
//     shared memory, three stages deep, so two chunks are in flight while
//     one is summed;
//   * splits K across blocks in whole groups, so narrow (k, v: O = 512) and
//     deep (down: K = 18944) shapes still fill the card; the grid is
//     (column slab x K split) and the plan is ops/quant_matmul.small_plan;
//   * sums x * (nibble - 8) in f32 over a group's rows and applies the
//     group scale once per (row, column, group) to that partial;
//   * keeps the block's x slice in shared memory (loaded once) and the
//     accumulators of up to 32 rows in registers;
//   * writes one f32 partial per split to a workspace [splits, N, O] that
//     the wrapper keeps; split_sum_kernel adds the splits in a fixed
//     order and writes x's dtype, so outputs are bit-identical from call to
//     call (no atomics).
//   Both activation types take it. f32 activations (and groups that are not
//   whole 16-row K steps) sum on f32 FMAs (w4_small_kernel). bf16
//   activations take w4a16_small_mma_kernel: the same grid, staging and
//   scale folding, with the products on mma.sync m16n8k16 (the nibbles
//   become exact bf16 values nibble - 8, the sums f32): on f32 FMAs a lane
//   spends ~90 instructions per packed word at N = 8, which bounds the
//   kernel by instruction issue instead of bytes (measured on the card:
//   1.5x torch._weight_int4pack_mm's device time, PERF.md).
//
// f32 activations (the CPU-parity configuration) at N > SMALL_N take a SIMT
// path with f32 FMAs on f32 q * scale (w4a32_simt_kernel), so a float32
// engine on the card keeps float32 arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wonly_tile.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nib_lo(uint32_t b) {
  return static_cast<float>(static_cast<int>(b & 0xFu) - 8);
}
__device__ __forceinline__ float nib_hi(uint32_t b) {
  return static_cast<float>(static_cast<int>((b >> 4) & 0xFu) - 8);
}

// ---- f32 activations: SIMT path -------------------------------------------
constexpr int FBM = 64, FBN = 64, FBK = 16;  // 256 threads, 4x4 outputs each

__global__ void __launch_bounds__(kThreads)
w4a32_simt_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int N, int K, int O, int group) {
  __shared__ float As[FBK][FBM + 4];  // x tile, transposed: As[k][row]
  __shared__ float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * FBM;
  const int col0 = blockIdx.x * FBN;
  const int Kp = K / 2;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int i = tid; i < FBM * FBK; i += kThreads) {
      const int r = i / FBK, c = i % FBK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < N && gc < K) ? x[(size_t)gr * K + gc] : 0.0f;
    }
    for (int i = tid; i < (FBK / 2) * FBN; i += kThreads) {
      const int pr = i / FBN, c = i % FBN;
      const int gp = k0 / 2 + pr, gc = col0 + c;
      float lo = 0.0f, hi = 0.0f;
      if (gp < Kp && gc < O) {
        const uint32_t b = w[(size_t)gp * O + gc];
        const float s = scale[(size_t)((2 * gp) / group) * O + gc];
        lo = nib_lo(b) * s;
        hi = nib_hi(b) * s;
      }
      Bs[2 * pr][c] = lo;
      Bs[2 * pr + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty * 4 + i, gc = col0 + tx * 4 + j;
      if (gr < N && gc < O) y[(size_t)gr * O + gc] = acc[i][j];
    }
}

// ---- small N: split-K SIMT path ---------------------------------------------
constexpr int kWarpCols = 128;   // output columns per warp: 32 lanes x 4
constexpr int kChunkRows = 32;   // packed rows per staged chunk (4 KB)
constexpr int kStages = 3;   // chunks a warp stages: 2 in flight while 1 is summed
// a staged packed row takes 160 bytes (128 + 32 of padding): the tensor-core
// variant's fragment loads then hit 32 distinct banks
constexpr int kTileStride = 160;
constexpr int kTileWords = kTileStride / 4;
constexpr int kTileBytes = kChunkRows * kTileStride;
constexpr int kSmallMaxRows = 32;

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// byte j of v4 (a nibble, 0..15) as the float nibble - 8: the byte goes into
// the mantissa of 2^23, and 2^23 + 8 comes off exactly
template <int j>
__device__ __forceinline__ float nib_f(uint32_t v4) {
  return __int_as_float(__byte_perm(v4, 0x4B000000u, 0x7540 | j)) - 8388616.0f;
}

// Stage packed rows [p0, p0 + rows) x columns [col0, col0 + 128) of w into
// a warp's tile (row-major, kTileStride bytes a row). VEC: O % 16 == 0 and w 16-byte
// aligned, so each lane copies whole 16-byte pieces asynchronously; else
// bytes, synchronously (ragged O only).
template <bool VEC>
__device__ __forceinline__ void stage_chunk(uint8_t* tile, const uint8_t* w,
                                            int p0, int rows, int col0, int O,
                                            int lane) {
  if (VEC) {
    for (int i = lane; i < rows * (kWarpCols / 16); i += 32) {
      const int r = i / (kWarpCols / 16), c = (i % (kWarpCols / 16)) * 16;
      const bool ok = col0 + c < O;
      cp_async16(tile + r * kTileStride + c,
                 ok ? w + (size_t)(p0 + r) * O + col0 + c : w, ok);
    }
  } else {
    for (int i = lane; i < rows * kWarpCols; i += 32) {
      const int r = i / kWarpCols, c = i % kWarpCols;
      tile[r * kTileStride + c] =
          col0 + c < O ? w[(size_t)(p0 + r) * O + col0 + c] : 0;
    }
  }
  cp_async_commit();
}

// grid (ceil(O / (128 * warps)), splits), block warps x 32. Split s covers
// groups [s * gps, min(G, (s + 1) * gps)); each warp a 128-column slab of
// it, lane l columns 4l..4l+3. Writes ws[s, n, o] for n < N, o < O.
// Dynamic shared memory: the x slice, gps * group * NP floats, then
// kStages tiles of kTileBytes per warp.
template <typename T, int NP, bool VEC>
__global__ void __launch_bounds__(128)
w4_small_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ ws,
                int N, int K, int O, int group, int gps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = K / group, R = group / 2;   // groups; packed rows a group
  const int split = blockIdx.y;
  const int g0 = split * gps, g1 = min(G, g0 + gps);
  const int kx0 = g0 * group, nk = (g1 - g0) * group;
  float* xs = reinterpret_cast<float*>(smem);                  // [nk][NP]
  uint8_t* tiles = smem + (size_t)gps * group * NP * sizeof(float) +
                   (size_t)warp * kStages * kTileBytes;
  const int col0 = (blockIdx.x * warps + warp) * kWarpCols;
  const int col = col0 + lane * 4;
  const bool live = col0 < O;   // the last block's spare warps only load x
  const int cpg = (R + kChunkRows - 1) / kChunkRows;   // chunks a group
  const int nchunks = (g1 - g0) * cpg;

  auto chunk_at = [&](int i, int& g, int& c, int& rows) {
    g = g0 + i / cpg;
    c = i % cpg;
    rows = min(kChunkRows, R - c * kChunkRows);
  };
  // chunk i goes to tile i % kStages; past the last chunk an empty group
  // keeps the wait count exact
  auto stage = [&](int i) {
    if (i < nchunks) {
      int g, c, rows;
      chunk_at(i, g, c, rows);
      stage_chunk<VEC>(tiles + (i % kStages) * kTileBytes, w,
                       g * R + c * kChunkRows, rows, col0, O, lane);
    } else {
      cp_async_commit();
    }
  };
  if (live)
    for (int i = 0; i < kStages - 1; ++i) stage(i);
  for (int i0 = threadIdx.x; i0 < NP * nk; i0 += 4 * blockDim.x) {
    float v[4];   // four loads in flight, then four stores
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x, n = i / nk, k = i % nk;
      v[u] = i < NP * nk && n < N ? load_f(x[(size_t)n * K + kx0 + k]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < NP * nk) xs[(i % nk) * NP + i / nk] = v[u];
    }
  }
  __syncthreads();
  if (!live) return;   // no block-wide barrier follows

  float acc[NP][4], part[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = part[n][j] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    stage(i + kStages - 1);
    int g, c, rows;
    chunk_at(i, g, c, rows);
    const bool last = c == cpg - 1;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (last) {   // issued before the sums, used after them
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < O) s[j] = scale[(size_t)g * O + col + j];
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(
        tiles + (i % kStages) * kTileBytes);
    const float* xk = xs + ((g - g0) * group + c * kChunkRows * 2) * NP;
    for (int r = 0; r < rows; ++r) {
      const uint32_t v = tw[r * kTileWords + lane];
      const uint32_t vl = v & 0x0F0F0F0Fu, vh = (v >> 4) & 0x0F0F0F0Fu;
      const float lo[4] = {nib_f<0>(vl), nib_f<1>(vl), nib_f<2>(vl), nib_f<3>(vl)};
      const float hi[4] = {nib_f<0>(vh), nib_f<1>(vh), nib_f<2>(vh), nib_f<3>(vh)};
      const float* xa = xk + 2 * r * NP;
#pragma unroll
      for (int n4 = 0; n4 < NP; n4 += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xa + n4);
        const float4 b = *reinterpret_cast<const float4*>(xa + NP + n4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[n4 + m][j] =
                fmaf(bv[m], hi[j], fmaf(av[m], lo[j], part[n4 + m][j]));
      }
    }
    if (last) {   // the group's partial is complete: fold its scale once
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[n][j] = fmaf(s[j], part[n][j], acc[n][j]);
          part[n][j] = 0.0f;
        }
    }
    __syncwarp();   // the tile is read before stage(i + kStages) refills it
  }

  float* out = ws + (size_t)split * N * O;
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    if (n >= N) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < O) out[(size_t)n * O + col + j] = acc[n][j];
  }
}

// Byte j of lo4 and of hi4 (the low and the high nibble of one packed byte:
// unpacked rows 2p and 2p + 1 of one column) as a bf16 pair (nibble - 8):
// each nibble goes into the mantissa of bf16 128.0, and 136 comes off
// exactly.
template <int j>
__device__ __forceinline__ uint32_t nib_pair(uint32_t lo4, uint32_t hi4) {
  uint32_t r = __byte_perm(lo4, hi4, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
  r = (r & 0x00FF00FFu) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// The small-N path for bf16 activations and groups of whole 16-row K steps:
// w4_small_kernel's grid, staging, split and scale folding, with the
// products on mma.sync m16n8k16 (bf16 in, f32 out) instead of f32 FMAs; the
// weights are the A operand (16 output columns x 16 k), x the B operand
// (16 k x 8 rows, NT tiles of 8 rows). Lane (g = lane / 4, t = lane % 4)
// reads, per K step, the 32-bit words 8i + g (i = 0..3, columns
// 32i + 4g .. 32i + 4g + 3) of packed rows t and t + 4; byte j of word i
// holds both nibbles, i.e. both k rows of a pair, of column 32i + 4g + j.
// So the warp's 128 columns form 8 M tiles (q = 0, 1; j = 0..3) whose A row
// g is column 64q + 4g + j and A row g + 8 is column 64q + 32 + 4g + j.
// Each group's product lands in fresh f32 accumulators `part`, folded into
// `acc` with the group's scale at the group's last K step.
template <int NT, bool VEC>
__global__ void __launch_bounds__(128)
w4a16_small_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ ws,
                       int N, int K, int O, int group, int gps, int xstride,
                       int xvec) {
  constexpr int NP = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = K / group, R = group / 2;
  const int split = blockIdx.y;
  const int g0 = split * gps, g1 = min(G, g0 + gps);
  const int kx0 = g0 * group, nk = (g1 - g0) * group;
  // x slice, bf16 [NP][xstride] (xstride / 2 words = 4 mod 32: the
  // fragment loads of the 8 rows x 4 lanes hit distinct banks)
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* tiles = smem + (size_t)NP * xstride * sizeof(__nv_bfloat16) +
                   (size_t)warp * kStages * kTileBytes;
  const int col0 = (blockIdx.x * warps + warp) * kWarpCols;
  const bool live = col0 < O;
  const int cpg = (R + kChunkRows - 1) / kChunkRows;
  const int nchunks = (g1 - g0) * cpg;

  auto chunk_at = [&](int i, int& gi, int& c, int& rows) {
    gi = g0 + i / cpg;
    c = i % cpg;
    rows = min(kChunkRows, R - c * kChunkRows);
  };
  auto stage = [&](int i) {   // as in w4_small_kernel
    if (i < nchunks) {
      int gi, c, rows;
      chunk_at(i, gi, c, rows);
      stage_chunk<VEC>(tiles + (i % kStages) * kTileBytes, w,
                       gi * R + c * kChunkRows, rows, col0, O, lane);
    } else {
      cp_async_commit();
    }
  };
  // the x slice first, asynchronously where x allows 16-byte pieces (rows
  // past N zero-filled), so it is in flight with the first weight chunks
  if (xvec) {
    const int pieces = nk / 8;
    for (int i = threadIdx.x; i < NP * pieces; i += blockDim.x) {
      const int n = i / pieces, k = (i % pieces) * 8;
      const bool ok = n < N;
      cp_async16(xs + n * xstride + k, ok ? x + (size_t)n * K + kx0 + k : x, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < NP * nk; i += blockDim.x) {
      const int n = i / nk, k = i % nk;
      xs[n * xstride + k] = n < N ? x[(size_t)n * K + kx0 + k] : zero;
    }
  }
  cp_async_commit();
  if (live) {
    for (int i = 0; i < kStages - 1; ++i) stage(i);
    cp_async_wait<kStages - 1>();   // the x group, committed first, is done
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  if (!live) return;

  float acc[NT][8][4], part[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][m][e] = part[nt][m][e] = 0.0f;

  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs);
  const int xw_stride = xstride / 2;
  for (int i = 0; i < nchunks; ++i) {
    stage(i + kStages - 1);
    int gi, c, rows;
    chunk_at(i, gi, c, rows);
    const bool last = c == cpg - 1;
    float s[8][2];   // [M tile][A row g, g + 8]
    if (last) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = col0 + 64 * (m / 4) + 32 * h + 4 * g + m % 4;
          s[m][h] = col < O ? scale[(size_t)gi * O + col] : 0.0f;
        }
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(
        tiles + (i % kStages) * kTileBytes);
    const int kb = (gi - g0) * group + c * kChunkRows * 2;   // in the slice
#pragma unroll 2
    for (int ks = 0; ks < rows / 8; ++ks) {
      uint32_t wd[2][4];   // [packed row t, t + 4][word 8i + g]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wd[h][q] = tw[(ks * 8 + t + 4 * h) * kTileWords + 8 * q + g];
      uint32_t lo[2][4], hi[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[h][q] = wd[h][q] & 0x0F0F0F0Fu;
          hi[h][q] = (wd[h][q] >> 4) & 0x0F0F0F0Fu;
        }
      uint32_t b[NT][2];
      const int kw = (kb + ks * 16) / 2 + t;   // word of k = kb + 16 ks + 2t
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = xw[(nt * 8 + g) * xw_stride + kw];
        b[nt][1] = xw[(nt * 8 + g) * xw_stride + kw + 4];
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int q = m / 4;   // words 2q (A row g) and 2q + 1 (A row g + 8)
        uint32_t a[4];
#define QM4_PAIR(J)                                            \
  if (m % 4 == J) {                                            \
    a[0] = nib_pair<J>(lo[0][2 * q], hi[0][2 * q]);            \
    a[1] = nib_pair<J>(lo[0][2 * q + 1], hi[0][2 * q + 1]);    \
    a[2] = nib_pair<J>(lo[1][2 * q], hi[1][2 * q]);            \
    a[3] = nib_pair<J>(lo[1][2 * q + 1], hi[1][2 * q + 1]);    \
  }
        QM4_PAIR(0)
        QM4_PAIR(1)
        QM4_PAIR(2)
        QM4_PAIR(3)
#undef QM4_PAIR
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(part[nt][m], a, b[nt][0], b[nt][1]);
      }
    }
    if (last) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[nt][m][e] = fmaf(s[m][e / 2], part[nt][m][e], acc[nt][m][e]);
            part[nt][m][e] = 0.0f;
          }
    }
    __syncwarp();
  }

  float* out = ws + (size_t)split * N * O;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * 8 + 2 * t + e % 2;
        const int col = col0 + 64 * (m / 4) + 32 * (e / 2) + 4 * g + m % 4;
        if (n < N && col < O) out[(size_t)n * O + col] = acc[nt][m][e];
      }
}

template <typename T, int NP, bool VEC>
cudaError_t launch_small_np(const T* x, const uint8_t* w, const float* scale,
                            float* ws, int N, int K, int O, int group,
                            int warps, int gps, int splits, size_t smem,
                            cudaStream_t s) {
  auto kernel = w4_small_kernel<T, NP, VEC>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  const int slab = warps * kWarpCols;
  dim3 grid((O + slab - 1) / slab, splits);
  kernel<<<grid, warps * 32, smem, s>>>(x, w, scale, ws, N, K, O, group, gps);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_small_vec(const T* x, const uint8_t* w, const float* scale,
                             float* ws, int N, int K, int O, int group,
                             int warps, int gps, int splits, size_t smem_tiles,
                             cudaStream_t s) {
#define QM4_SMALL(NP)                                                         \
  if (N <= NP)                                                                \
    return launch_small_np<T, NP, VEC>(                                       \
        x, w, scale, ws, N, K, O, group, warps, gps, splits,                  \
        smem_tiles + (size_t)gps * group * NP * sizeof(float), s);
  QM4_SMALL(4)
  QM4_SMALL(8)
  QM4_SMALL(16)
  QM4_SMALL(32)
#undef QM4_SMALL
  return cudaErrorInvalidValue;
}

template <int NT, bool VEC>
cudaError_t launch_mma_nt(const __nv_bfloat16* x, const uint8_t* w,
                          const float* scale, float* ws, int N, int K, int O,
                          int group, int warps, int gps, int splits,
                          size_t smem_tiles, cudaStream_t s) {
  auto kernel = w4a16_small_mma_kernel<NT, VEC>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  // x rows of gps * group bf16, padded to a word count of 4 mod 32
  const int words = (gps * group) / 2;
  const int xstride = 2 * (((words + 27) / 32) * 32 + 4);
  const size_t smem = smem_tiles + (size_t)8 * NT * xstride * 2;
  const int slab = warps * kWarpCols;
  dim3 grid((O + slab - 1) / slab, splits);
  // 16-byte x pieces: x aligned, every row and slice start on 8 elements
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
  kernel<<<grid, warps * 32, smem, s>>>(x, w, scale, ws, N, K, O, group, gps,
                                        xstride, xvec);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_mma(const __nv_bfloat16* x, const uint8_t* w,
                       const float* scale, float* ws, int N, int K, int O,
                       int group, int warps, int gps, int splits,
                       size_t smem_tiles, cudaStream_t s) {
  if (N <= 8)
    return launch_mma_nt<1, VEC>(x, w, scale, ws, N, K, O, group, warps, gps,
                                 splits, smem_tiles, s);
  if (N <= 16)
    return launch_mma_nt<2, VEC>(x, w, scale, ws, N, K, O, group, warps, gps,
                                 splits, smem_tiles, s);
  return launch_mma_nt<4, VEC>(x, w, scale, ws, N, K, O, group, warps, gps,
                               splits, smem_tiles, s);
}

// ---- bf16 activations, N > SMALL_N: the tile path (wonly_tile.cuh) --------
// K5's weight policy. A staged K step holds 32 packed rows (64 k) of the
// block's columns, 160 or 288 bytes a row (128 or 256 columns + 32: packed
// rows t = 0..3 then start 8 banks apart, so the 8 x 4 lanes' word loads hit
// 32 banks). For 16-k step ks, lane (g, t) reads the words of columns
// 4g..4g+3 and 32+4g..32+4g+3 of packed rows 8ks + t (k = 2t, 2t + 1) and
// 8ks + t + 4 (k = 2t + 8, 2t + 9); byte m of a word holds both k of one
// column, which nib_pair turns into the exact bf16 pair (nibble - 8). The
// mainloop multiplies each pair by its group's scale as a bf16 pair
// (__hmul2) before the mma: one f32 accumulator set, and q x scale rounded
// to bf16 as the JAX bf16 path rounds it (the scale itself is rounded to
// bf16 first). Folding the scale on f32 per-group
// partials, as the small path does, would need a second accumulator set of
// 64 registers a thread.
template <int J>
__device__ __forceinline__ void w4_col(uint32_t (&a)[4], const uint32_t (&lo)[4],
                                       const uint32_t (&hi)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = nib_pair<J>(lo[r], hi[r]);
}

struct W4Tile {
  static constexpr int kRows = kTileK / 2;
  static constexpr int kPad = 32;
  static constexpr bool kGroups = true;
  static constexpr bool kColScale = false;
  __device__ static __forceinline__ void a_frags(const unsigned char* wt,
                                                 int stride, int ks, int g,
                                                 int t, uint32_t (&a)[4][4]) {
    const unsigned char* r0 = wt + (ks * 8 + t) * stride + 4 * g;
    const unsigned char* r1 = r0 + 4 * stride;
    // A registers: [0] row g, k 2t; [1] row g + 8, k 2t; [2] row g, k 2t + 8;
    // [3] row g + 8, k 2t + 8
    const uint32_t v[4] = {*reinterpret_cast<const uint32_t*>(r0),
                           *reinterpret_cast<const uint32_t*>(r0 + 32),
                           *reinterpret_cast<const uint32_t*>(r1),
                           *reinterpret_cast<const uint32_t*>(r1 + 32)};
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lo[r] = v[r] & 0x0F0F0F0Fu;
      hi[r] = (v[r] >> 4) & 0x0F0F0F0Fu;
    }
    w4_col<0>(a[0], lo, hi);
    w4_col<1>(a[1], lo, hi);
    w4_col<2>(a[2], lo, hi);
    w4_col<3>(a[3], lo, hi);
  }
};

// bf16 activations with groups of whole 16-row K steps take the
// tensor-core variant; f32 activations and other groups the f32 FMA one
template <typename T>
bool takes_mma(int group) { return false; }
template <>
bool takes_mma<__nv_bfloat16>(int group) { return group % 16 == 0; }

template <typename T>
cudaError_t launch_small_kernel(const T* x, const uint8_t* w,
                                const float* scale, float* ws, int N, int K,
                                int O, int group, int warps, int gps,
                                int splits, size_t smem_tiles, bool vec,
                                cudaStream_t s) {
  return vec ? launch_small_vec<T, true>(x, w, scale, ws, N, K, O, group,
                                         warps, gps, splits, smem_tiles, s)
             : launch_small_vec<T, false>(x, w, scale, ws, N, K, O, group,
                                          warps, gps, splits, smem_tiles, s);
}
template <>
cudaError_t launch_small_kernel<__nv_bfloat16>(
    const __nv_bfloat16* x, const uint8_t* w, const float* scale, float* ws,
    int N, int K, int O, int group, int warps, int gps, int splits,
    size_t smem_tiles, bool vec, cudaStream_t s) {
  if (takes_mma<__nv_bfloat16>(group))
    return vec ? launch_mma<true>(x, w, scale, ws, N, K, O, group, warps, gps,
                                  splits, smem_tiles, s)
               : launch_mma<false>(x, w, scale, ws, N, K, O, group, warps, gps,
                                   splits, smem_tiles, s);
  return vec ? launch_small_vec<__nv_bfloat16, true>(
                   x, w, scale, ws, N, K, O, group, warps, gps, splits,
                   smem_tiles, s)
             : launch_small_vec<__nv_bfloat16, false>(
                   x, w, scale, ws, N, K, O, group, warps, gps, splits,
                   smem_tiles, s);
}

template <typename T>
cudaError_t launch_small(const T* x, const uint8_t* w, const float* scale,
                         float* ws, T* y, int N, int K, int O, int group,
                         int warps, int splits, cudaStream_t s) {
  const int G = K / group;
  const int gps = (G + splits - 1) / splits;
  if ((G + gps - 1) / gps != splits) return cudaErrorInvalidValue;
  const size_t smem_tiles = (size_t)warps * kStages * kTileBytes;
  const bool vec = O % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err = launch_small_kernel(x, w, scale, ws, N, K, O, group,
                                        warps, gps, splits, smem_tiles, vec, s);
  if (err != cudaSuccess) return err;
  const int total = N * O;
  split_sum_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(ws, y, splits, total,
                                                           nullptr, O);
  return cudaGetLastError();
}

}  // namespace

// The tile path. dtype: 0 = float32 activations (w4a32_simt_kernel; ws and
// the plan unused), 1 = bfloat16 (the mma.sync tile kernel of
// wonly_tile.cuh; group % 16 == 0). x [N, K], w [K/2, O] packed uint8,
// scale [K/group, O] float32, y [N, O] in x's dtype, all dense row-major;
// ws a float32 workspace of [splits, N, O] (null when splits == 1); the
// plan (nt, wr, splits, kps) is ops/quant_matmul.tile_plan's. Returns the
// cudaError_t of the launches (0 = success). Launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int quant_matmul4_launch(int dtype, const void* x, const void* w,
                                    const void* scale, void* y, void* ws,
                                    int N, int K, int O, int group, int nt,
                                    int wr, int splits, int kps, void* stream) {
  if (group <= 0 || group % 2 != 0 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (group % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tile_launch<W4Tile>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(ws), N, K, O, group, nt, wr, splits, kps, s));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((O + FBN - 1) / FBN, (N + FBM - 1) / FBM);
  w4a32_simt_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), N, K, O,
      group);
  return static_cast<int>(cudaGetLastError());
}

// The small-N path: x [N, K] (1 <= N <= 32), w, scale and y as above, ws a
// float32 workspace of [splits, N, O]; `warps` (1, 2 or 4) warps a block,
// each a 128-column slab, and `splits` K splits of whole groups, splits ==
// ceil(G / ceil(G / splits)) for G = K / group (ops/quant_matmul.small_plan).
// Launches the split kernel and the split sum on `stream`; returns the
// cudaError_t (0 = success). Allocates nothing, does not synchronise.
extern "C" int quant_matmul4_small_launch(int dtype, const void* x,
                                          const void* w, const void* scale,
                                          void* y, void* ws, int N, int K,
                                          int O, int group, int warps,
                                          int splits, void* stream) {
  if (group <= 0 || group % 2 != 0 || K % group != 0 || N < 1 ||
      N > kSmallMaxRows || splits < 1 || splits > K / group ||
      (warps != 1 && warps != 2 && warps != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* wq = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err;
  if (dtype == 1)
    err = launch_small(static_cast<const __nv_bfloat16*>(x), wq, sc, wsf,
                       static_cast<__nv_bfloat16*>(y), N, K, O, group, warps,
                       splits, s);
  else if (dtype == 0)
    err = launch_small(static_cast<const float*>(x), wq, sc, wsf,
                       static_cast<float*>(y), N, K, O, group, warps, splits, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
