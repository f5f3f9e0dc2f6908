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
// (K/group)*O*4 scale bytes once and does 2*N*K*O operations. At a text
// decode step (N = 8) it is bound by those bytes, half of K1's; at the
// serving tick (N = 232) by the tensor cores, as K1 is. The design follows
// K1 (csrc/quant_matmul.cu): per block a 64 x 128 output tile; each K step of
// 32 unpacked rows reads 16 packed rows of the weight tile once as uint8_t
// (four columns per 32-bit word where the layout allows), unpacks both
// nibbles in registers and writes bf16(q * scale) straight into rows 2i and
// 2i+1 of a bf16 shared-memory tile, so x needs no even/odd split (that
// split was a Mosaic workaround on the TPU). The scale changes every `group`
// rows of K and so does not factor out of the K sum: it is folded into the
// weight before the product, rounding each weight once to bf16 (the JAX CPU
// path rounds q * scale in bf16 the same way). The product runs on WMMA
// 16x16x16 bf16 fragments with f32 accumulation. The alternative, an f32
// partial per group scaled and added, needs a known accumulator layout
// (mma.sync) and is left for a later version, with wgmma/TMA and double
// buffering. `group` is an argument (any even divisor of K); ragged N and O
// are masked, not padded. Nibbles are read as unsigned bytes, so the value
// nibble - 8 spans -8..7 (the quantizer never writes nibble 0, -8, but the
// kernel computes it).
//
// f32 activations (the CPU-parity configuration) take a SIMT path with f32
// FMAs on f32 q * scale, so a float32 engine on the card keeps float32
// arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nib_lo(uint32_t b) {
  return static_cast<float>(static_cast<int>(b & 0xFu) - 8);
}
__device__ __forceinline__ float nib_hi(uint32_t b) {
  return static_cast<float>(static_cast<int>((b >> 4) & 0xFu) - 8);
}

// ---- bf16 activations: WMMA tensor-core path ------------------------------
constexpr int BM = 64;   // rows of x per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // unpacked K rows per step (16 packed rows)
constexpr int A_LD = BK + 8;   // bf16 elements; 80-byte rows
constexpr int B_LD = BN + 8;   // bf16 elements; 272-byte rows
constexpr int C_LD = BN + 4;   // floats

__global__ void __launch_bounds__(kThreads)
w4a16_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ y, int N, int K, int O,
                  int group, int vec4) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 2 warp rows of 32
  const int wn = warp % 4;  // 4 warp columns of 32
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int Kp = K / 2;
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
    const int p0 = k0 / 2;
    if (vec4) {  // O % 4 == 0, w 4-byte and scale 16-byte aligned
      for (int i = tid; i < (BK / 2) * (BN / 4); i += kThreads) {
        const int pr = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const int gp = p0 + pr, gc = col0 + c;
        __nv_bfloat16* lo = Bs + (2 * pr) * B_LD + c;
        __nv_bfloat16* hi = lo + B_LD;
        if (gp < Kp && gc < O) {
          const uchar4 v = *reinterpret_cast<const uchar4*>(w + (size_t)gp * O + gc);
          const float4 s = *reinterpret_cast<const float4*>(
              scale + (size_t)((2 * gp) / group) * O + gc);
          lo[0] = __float2bfloat16(nib_lo(v.x) * s.x);
          lo[1] = __float2bfloat16(nib_lo(v.y) * s.y);
          lo[2] = __float2bfloat16(nib_lo(v.z) * s.z);
          lo[3] = __float2bfloat16(nib_lo(v.w) * s.w);
          hi[0] = __float2bfloat16(nib_hi(v.x) * s.x);
          hi[1] = __float2bfloat16(nib_hi(v.y) * s.y);
          hi[2] = __float2bfloat16(nib_hi(v.z) * s.z);
          hi[3] = __float2bfloat16(nib_hi(v.w) * s.w);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) lo[j] = hi[j] = zero;
        }
      }
    } else {
      for (int i = tid; i < (BK / 2) * BN; i += kThreads) {
        const int pr = i / BN, c = i % BN;
        const int gp = p0 + pr, gc = col0 + c;
        __nv_bfloat16 lo = zero, hi = zero;
        if (gp < Kp && gc < O) {
          const uint32_t b = w[(size_t)gp * O + gc];
          const float s = scale[(size_t)((2 * gp) / group) * O + gc];
          lo = __float2bfloat16(nib_lo(b) * s);
          hi = __float2bfloat16(nib_hi(b) * s);
        }
        Bs[(2 * pr) * B_LD + c] = lo;
        Bs[(2 * pr + 1) * B_LD + c] = hi;
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
      y[(size_t)gr * O + gc] = __float2bfloat16(Cs[r * C_LD + c]);
  }
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

}  // namespace

// dtype: 0 = float32 activations, 1 = bfloat16 activations. x [N, K],
// w [K/2, O] packed uint8, scale [K/group, O] float32, y [N, O] in x's dtype,
// all dense row-major. Returns the cudaError_t of the launch (0 = success).
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int quant_matmul4_launch(int dtype, const void* x, const void* w,
                                    const void* scale, void* y, int N, int K,
                                    int O, int group, void* stream) {
  if (group <= 0 || group % 2 != 0 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // word loads of w and float4 loads of scale need whole 4-column groups
    // on aligned bases
    const int vec4 = O % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(scale) % 16 == 0;
    dim3 grid((O + BN - 1) / BN, (N + BM - 1) / BM);
    w4a16_wmma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        N, K, O, group, vec4);
  } else if (dtype == 0) {
    dim3 grid((O + FBN - 1) / FBN, (N + FBM - 1) / FBM);
    w4a32_simt_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), N, K, O,
        group);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
