// K1: weight-only int8 matmul, y[N,O] = x[N,K] @ (w_q[K,O] * scale[O]).
//
// Replaces the TPU kernel freeze_omni_tpu/ops/quant_matmul.py:quant_matmul
// (body _kernel). Built for sm_90a by ops/_build.py and bound with ctypes
// (ops/quant_matmul.py).
//
// What bounds it on an H100: at the serving tick's N (8 sessions x 29 tokens
// = 232 rows) the call moves K*O int8 weight bytes once and does 2*N*K*O
// operations; the crossover of 3.35 TB/s against 989 TFLOP/s bf16 lies near
// N = 148, so small N (the 89-token role prefill, one-token decode) is bound
// by weight bytes and the 232-row tick sits just above the line, on the
// tensor cores. The design reads each int8 weight tile from device memory
// once per block row, converts it to bf16 in shared memory (exact: |w| <= 127
// fits bf16's 8-bit mantissa), and feeds the tensor cores through WMMA
// 16x16x16 bf16 fragments with f32 accumulation. scale[o] factors out of the
// K sum, so it is applied once per output in the epilogue. Ragged N and O
// edges are masked, not padded. No double buffering, TMA or wgmma yet: this
// is the first, simple version.
//
// f32 activations (the CPU-parity configuration) take a SIMT path with f32
// FMAs, so a float32 engine on the card keeps float32 arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;

// ---- bf16 activations: WMMA tensor-core path ------------------------------
constexpr int BM = 64;   // rows of x per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // K step
constexpr int A_LD = BK + 8;   // bf16 elements; 80-byte rows
constexpr int B_LD = BN + 8;   // bf16 elements; 272-byte rows
constexpr int C_LD = BN + 4;   // floats

__global__ void __launch_bounds__(kThreads)
w8a16_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ y, int N, int K, int O,
                  int vec4) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 2 warp rows of 32
  const int wn = warp % 4;  // 4 warp columns of 32
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[r * A_LD + c] = (gr < N && gc < K) ? x[(size_t)gr * K + gc] : zero;
    }
    if (vec4) {  // O % 4 == 0 and w 4-byte aligned: one word per thread step
      for (int i = tid; i < BK * (BN / 4); i += kThreads) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int gr = k0 + r, gc = col0 + c;
        char4 v = make_char4(0, 0, 0, 0);
        if (gr < K && gc < O)
          v = *reinterpret_cast<const char4*>(w + (size_t)gr * O + gc);
        __nv_bfloat16* dst = Bs + r * B_LD + c;
        dst[0] = __float2bfloat16((float)v.x);
        dst[1] = __float2bfloat16((float)v.y);
        dst[2] = __float2bfloat16((float)v.z);
        dst[3] = __float2bfloat16((float)v.w);
      }
    } else {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;
        const int gr = k0 + r, gc = col0 + c;
        Bs[r * B_LD + c] = (gr < K && gc < O)
            ? __float2bfloat16((float)w[(size_t)gr * O + gc]) : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < N && gc < O)
      y[(size_t)gr * O + gc] = __float2bfloat16(Cs[r * C_LD + c] * scale[gc]);
  }
}

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

// dtype: 0 = float32 activations, 1 = bfloat16 activations. Returns the
// cudaError_t of the launch (0 = success). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int quant_matmul_launch(int dtype, const void* x, const void* w,
                                   const void* scale, void* y, int N, int K,
                                   int O, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // word loads of w need whole 4-byte rows on a 4-byte-aligned base
    const int vec4 = O % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
    dim3 grid((O + BN - 1) / BN, (N + BM - 1) / BM);
    w8a16_wmma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        N, K, O, vec4);
  } else if (dtype == 0) {
    dim3 grid((O + FBN - 1) / FBN, (N + FBM - 1) / FBM);
    w8a32_simt_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), N, K, O);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
