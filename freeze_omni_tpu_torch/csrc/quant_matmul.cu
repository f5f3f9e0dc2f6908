// K1: weight-only int8 matmul, y[N,O] = x[N,K] @ (w_q[K,O] * scale[O]).
//
// Replaces the TPU kernel freeze_omni_tpu/ops/quant_matmul.py:quant_matmul
// (body _kernel). Built for sm_90a by ops/_build.py and bound with ctypes
// (ops/quant_matmul.py).
//
// What bounds it on an H100: the call moves K*O int8 weight bytes once and
// does 2*N*K*O operations; the crossover of 3.35 TB/s against 989 TFLOP/s
// bf16 lies near N = 148. At the serving tick (N = 232: 8 sessions x 29
// tokens) one layer's 7 projections are bound by operations (108 GFLOP,
// 0.109 ms); at a text-decode step (N = 8, with the 3584 x 152064 lm_head)
// by the weight bytes (778 MB, 0.234 ms).
//
// bf16 activations at every N take the tile path, the mma.sync mainloop
// that K5 shares (wonly_tile.cuh), with K1's weight policy W8Tile below:
// a 4-stage cp.async ring of x and int8 weight tiles keeps three K steps of
// loads in flight while one is summed, which is what a bytes-bound call
// needs; the weights are converted in registers (exact, no shared-memory
// round trip) and multiplied on the tensor cores, which is what the
// operations-bound tick needs; split-K in whole K steps fills the card
// where the tile grid is small (q, k, v, o and down at N = 232). scale[o]
// factors out of the K sum, so it is applied once per output, in the
// epilogue or in the split sum. At N = 8 a warp takes one 8-row n8 tile,
// so no mma row is padding; a split-K design for small N that reads each
// weight byte once at the full memory rate is later work (ROADMAP E).
//
// f32 activations (the CPU-parity configuration) take a SIMT path with f32
// FMAs, so a float32 engine on the card keeps float32 arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wonly_tile.cuh"

namespace {

constexpr int kThreads = 256;

// ---- bf16 activations: the tile path (wonly_tile.cuh) ---------------------
// Byte j of row k's word and of row k+1's word (one column, k and k+1) as
// an exact bf16 pair: the low 7 bits go into the mantissa of bf16 128.0,
// the sign bit into the exponent of the subtrahend (128 or 256), so
// (128 + low7) - (128 + 128 * sign) = the int8 value.
template <int j>
__device__ __forceinline__ uint32_t i8_pair(uint32_t k0, uint32_t k1) {
  const uint32_t r = __byte_perm(k0, k1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
  uint32_t v = (r & 0x007F007Fu) | 0x43004300u;
  uint32_t b = (r & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&d);
}

template <int J>
__device__ __forceinline__ void w8_col(uint32_t (&a)[4], const uint32_t (&v)[4][2]) {
  a[0] = i8_pair<J>(v[0][0], v[1][0]);   // row g, k 2t and 2t + 1
  a[1] = i8_pair<J>(v[0][1], v[1][1]);   // row g + 8
  a[2] = i8_pair<J>(v[2][0], v[3][0]);   // row g, k 2t + 8 and 2t + 9
  a[3] = i8_pair<J>(v[2][1], v[3][1]);   // row g + 8
}

// K1's weight policy. A staged K step holds 64 int8 rows of the block's
// columns, 144 or 272 bytes a row (128 or 256 columns + 16: rows 2t then
// start 8 banks apart, so the 8 x 4 lanes' word loads hit 32 banks). For
// 16-k step ks, lane (g, t) reads the words of columns 4g..4g+3 and
// 32+4g..32+4g+3 of rows 16ks + 2t, + 1, + 8 and + 9; byte m of a row's
// word and of the next row's is the (k, k + 1) pair of column 4g + m.
struct W8Tile {
  static constexpr int kRows = kTileK;
  static constexpr int kPad = 16;
  static constexpr bool kGroups = false;
  static constexpr bool kColScale = true;
  __device__ static __forceinline__ void a_frags(const unsigned char* wt,
                                                 int stride, int ks, int g,
                                                 int t, uint32_t (&a)[4][4]) {
    const unsigned char* r = wt + (16 * ks + 2 * t) * stride + 4 * g;
    uint32_t v[4][2];   // [row 2t, 2t + 1, 2t + 8, 2t + 9][column half]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[i][h] = *reinterpret_cast<const uint32_t*>(
            r + ((i & 1) + 8 * (i >> 1)) * stride + 32 * h);
    w8_col<0>(a[0], v);
    w8_col<1>(a[1], v);
    w8_col<2>(a[2], v);
    w8_col<3>(a[3], v);
  }
};

// ---- f32 activations: SIMT path -------------------------------------------
constexpr int FBM = 64, FBN = 64, FBK = 16;  // 256 threads, 4x4 outputs each

__global__ void __launch_bounds__(kThreads)
w8a32_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y,
                  int N, int K, int O) {
  __shared__ float As[FBK][FBM + 4];  // x tile, transposed: As[k][row]
  __shared__ float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * FBM;
  const int col0 = blockIdx.x * FBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int i = tid; i < FBM * FBK; i += kThreads) {
      const int r = i / FBK, c = i % FBK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < N && gc < K) ? x[(size_t)gr * K + gc] : 0.0f;
    }
    for (int i = tid; i < FBK * FBN; i += kThreads) {
      const int r = i / FBN, c = i % FBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < O) ? (float)w[(size_t)gr * O + gc] : 0.0f;
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
      if (gr < N && gc < O) y[(size_t)gr * O + gc] = acc[i][j] * scale[gc];
    }
}

}  // namespace

// dtype: 0 = float32 activations (w8a32_simt_kernel; ws and the plan
// unused), 1 = bfloat16 (the mma.sync tile kernel of wonly_tile.cuh). x
// [N, K], w [K, O] int8, scale [O] float32, y [N, O] in x's dtype, all
// dense row-major; ws a float32 workspace of [splits, N, O] (null when
// splits == 1); the plan (nt, wr, splits, kps) is ops/quant_matmul.
// tile_plan's. Returns the cudaError_t of the launches (0 = success).
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int quant_matmul_launch(int dtype, const void* x, const void* w,
                                   const void* scale, void* y, void* ws,
                                   int N, int K, int O, int nt, int wr,
                                   int splits, int kps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(tile_launch<W8Tile>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(ws), N, K, O, 1, nt, wr, splits, kps, s));
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((O + FBN - 1) / FBN, (N + FBM - 1) / FBM);
  w8a32_simt_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), N, K, O);
  return static_cast<int>(cudaGetLastError());
}
