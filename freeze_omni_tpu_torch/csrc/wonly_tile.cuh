// The tile path shared by K1 (csrc/quant_matmul.cu, int8 weights) and K5
// (csrc/quant_matmul4.cu, grouped int4 weights): y[N, O] = x[N, K] @ W for
// bf16 activations, W dequantized from its packed bytes inside the kernel.
//
// One mainloop for both weight formats; each file instantiates it with its
// own weight policy (how a staged weight tile becomes bf16 A fragments).
//
// - Tensor cores through mma.sync m16n8k16 (bf16 in, f32 sums) in the
//   swap-AB form: the weights are the A operand (16 output columns x 16 k),
//   x the B operand (16 k x 8 rows), so the mma's N dimension walks the
//   activation rows and N = 232 fills 29 n8 tiles with no 64-row padding.
//   A warp owns 64 output columns (4 M tiles) x 8 * NT rows (NT n8 tiles).
//   Lane (g = lane / 4, t = lane % 4) holds, for M tile m, A row g = column
//   4g + m and A row g + 8 = column 32 + 4g + m of the warp's 64, so the
//   four M tiles of one lane cover 4 adjacent columns and its epilogue
//   writes 4 adjacent outputs at once.
// - A ring of kTileStages K steps of kTileK = 64 k in shared memory, filled
//   with 16-byte cp.async (x tile, packed weight tile and, for K5, the scale
//   rows the step spans), one __syncthreads per K step. x fragments come
//   from the x tile by ldmatrix; weight fragments are read as 32-bit words
//   and dequantized in registers by the policy, never stored back.
//   Shapes whose rows are not whole 16-byte pieces (a ragged O, K % 8 != 0,
//   unaligned bases) take the same kernel with element loads (VEC = false,
//   NT = 4 only).
// - A block is 4 warps: wr along the rows and 4 / wr along the columns.
//   The plan (ops/quant_matmul.tile_plan) picks NT and wr from N, and
//   splits K in whole K steps (whole groups for K5) wherever the tile grid
//   would have fewer than 2 x 132 blocks. A split writes its f32 partial to
//   a workspace [splits, N, O]; split_sum_kernel adds the splits in a fixed
//   order (bit-identical calls, no atomics) and applies a per-column scale
//   where the policy has one. One split writes y from the epilogue.
//
// The small-N path of K5 (quant_matmul4.cu) shares the cp.async helpers,
// mma_bf16 and split_sum_kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

template <typename T> __device__ __forceinline__ T store_f(float v);
template <> __device__ __forceinline__ float store_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// y[i] = sum over s of ws[s, i], s in order, times colscale[i % O] where
// colscale is given, in y's type
template <typename T>
__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 T* __restrict__ y, int splits, int total,
                                 const float* __restrict__ colscale, int O) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * total + i];
  if (colscale != nullptr) sum *= colscale[i % O];
  y[i] = store_f<T>(sum);
}

constexpr int kTileK = 64;          // k per K step (one ring stage)
constexpr int kTileStages = 4;      // 3 K steps in flight while 1 is summed
constexpr int kTileThreads = 128;   // 4 warps
constexpr int kXStride = kTileK * 2 + 16;   // bytes a staged x row: 144, so
                                            // ldmatrix's 8 rows hit 32 banks
constexpr int kScaleRows = kTileK / 16;     // group rows a K step can span

// Bytes of one ring stage: the x tile, the weight tile and (K5) the scale
// rows. Mirrored by ops/quant_matmul.tile_smem_bytes.
template <class W>
__host__ __device__ constexpr int tile_stage_bytes(int nt, int wr) {
  return wr * 8 * nt * kXStride + W::kRows * ((4 / wr) * 64 + W::kPad) +
         (W::kGroups ? kScaleRows * (4 / wr) * 64 * 4 : 0);
}

// Policy W: kRows staged weight rows a K step (K1: 64 int8 rows; K5: 32
// packed rows of two k each), kPad bytes of padding a staged row (chosen so
// that the policy's fragment loads hit 32 distinct banks), kGroups (stage
// the group scales and fold them into the bf16 pairs), kColScale (a scale a
// column, applied in the epilogue), and a_frags(wt, stride, ks, g, t, a):
// the A fragments of the warp's 4 M tiles for 16-k step ks of the stage,
// from the warp's columns of the staged weight tile.
template <class W, int NT, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
wonly_tile_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                  int N, int K, int O, int group, int wr, int kps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wc = 4 / wr;
  const int BR = wr * 8 * NT, BO = wc * 64;
  const int wstride = BO + W::kPad;
  const int stage_bytes = tile_stage_bytes<W>(NT, wr);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / wc) * 8 * NT;   // the warp's rows in the block tile
  const int wcol = (warp % wc) * 64;       // and its columns
  const int row0 = blockIdx.y * BR, col0 = blockIdx.x * BO;
  const int steps = (K + kTileK - 1) / kTileK;
  const int kbeg = blockIdx.z * kps;
  const int nk = min(kps, steps - kbeg);
  const int wrows = K / kTileK * W::kRows + (K % kTileK) * W::kRows / kTileK;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  auto load = [&](int buf, int step) {
    unsigned char* st = smem + buf * stage_bytes;
    const int k0 = step * kTileK;
    if (VEC) {   // K % 8 == 0: a 16-byte piece of x is all in K or all out
      for (int i = threadIdx.x; i < BR * (kTileK / 8); i += kTileThreads) {
        const int r = i / (kTileK / 8), c = (i % (kTileK / 8)) * 8;
        const bool ok = row0 + r < N && k0 + c < K;
        cp_async16(st + r * kXStride + c * 2,
                   ok ? x + (size_t)(row0 + r) * K + k0 + c : x, ok);
      }
    } else {   // element loads, not unrolled: few registers held
#pragma unroll 1
      for (int i = threadIdx.x; i < BR * kTileK; i += kTileThreads) {
        const int r = i / kTileK, c = i % kTileK;
        const bool ok = row0 + r < N && k0 + c < K;
        *reinterpret_cast<__nv_bfloat16*>(st + r * kXStride + c * 2) =
            ok ? x[(size_t)(row0 + r) * K + k0 + c] : zero;
      }
    }
    unsigned char* wt = st + BR * kXStride;
    const int p0 = step * W::kRows;
    if (VEC) {   // O % 16 == 0: a 16-byte piece of a row is all in O or out
      for (int i = threadIdx.x; i < W::kRows * (BO / 16); i += kTileThreads) {
        const int r = i / (BO / 16), c = (i % (BO / 16)) * 16;
        const bool ok = p0 + r < wrows && col0 + c < O;
        cp_async16(wt + r * wstride + c,
                   ok ? w + (size_t)(p0 + r) * O + col0 + c : w, ok);
      }
    } else {   // element loads, not unrolled: few registers held
#pragma unroll 1
      for (int i = threadIdx.x; i < W::kRows * BO; i += kTileThreads) {
        const int r = i / BO, c = i % BO;
        wt[r * wstride + c] =
            p0 + r < wrows && col0 + c < O ? w[(size_t)(p0 + r) * O + col0 + c] : 0;
      }
    }
    if (W::kGroups) {   // scale rows k0 / group .. (last k of the step) / group
      float* ss = reinterpret_cast<float*>(wt + W::kRows * wstride);
      const int s0 = k0 / group;
      const int ns = (min(K, k0 + kTileK) - 1) / group - s0 + 1;
      if (VEC) {
        for (int i = threadIdx.x; i < ns * (BO / 4); i += kTileThreads) {
          const int r = i / (BO / 4), c = (i % (BO / 4)) * 4;
          const bool ok = col0 + c < O;
          cp_async16(ss + r * BO + c,
                     ok ? scale + (size_t)(s0 + r) * O + col0 + c : scale, ok);
        }
      } else {
#pragma unroll 1
        for (int i = threadIdx.x; i < ns * BO; i += kTileThreads) {
          const int r = i / BO, c = i % BO;
          ss[r * BO + c] = col0 + c < O ? scale[(size_t)(s0 + r) * O + col0 + c] : 0.0f;
        }
      }
    }
  };

  float acc[4][NT][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  for (int s = 0; s < kTileStages - 1; ++s) {
    if (s < nk) load(s, kbeg + s);
    cp_async_commit();
  }
  uint32_t s2[4][2];   // K5: the group scale of each A row, as a bf16 pair
  // K5: 16-k steps a group, and this step's place in its group (a counter,
  // not a division per step)
  const int gq = W::kGroups ? group / 16 : 1;
  int gpos = W::kGroups ? (kbeg * (kTileK / 16)) % gq : 0;
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kTileStages - 2>();
    // step i has landed, and every warp is done with step i - 1, whose
    // buffer the next load refills
    __syncthreads();
    if (i + kTileStages - 1 < nk)
      load((i + kTileStages - 1) % kTileStages, kbeg + i + kTileStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kTileStages) * stage_bytes;
    const unsigned char* wt = st + BR * kXStride;
    const float* ss = reinterpret_cast<const float*>(wt + W::kRows * wstride);
    const int k0 = (kbeg + i) * kTileK;
    int srow = 0;   // K5: the staged scale row of this 16-k step
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {
      if (k0 + 16 * ks >= K) break;   // past K: nothing staged
      if (W::kGroups && (ks == 0 || gpos == 0)) {
        const float* sr = ss + srow * BO + wcol + 4 * g;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v = __float2bfloat162_rn(sr[32 * h + m]);
            s2[m][h] = *reinterpret_cast<const uint32_t*>(&v);
          }
      }
      uint32_t b[NT][2];
      if (NT == 1) {
        uint32_t r[2];
        ldmatrix_x2(r, st + (wrow + lane % 8) * kXStride +
                           (16 * ks + ((lane / 8) % 2) * 8) * 2);
        b[0][0] = r[0];
        b[0][1] = r[1];
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, st + (wrow + 16 * p + (lane / 16) * 8 + lane % 8) * kXStride +
                             (16 * ks + ((lane / 8) % 2) * 8) * 2);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
      uint32_t a[4][4];
      W::a_frags(wt + wcol, wstride, ks, g, t, a);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (W::kGroups) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a[m][r]),
                                       *reinterpret_cast<__nv_bfloat162*>(&s2[m][r & 1]));
            a[m][r] = *reinterpret_cast<uint32_t*>(&v);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[m][n], a[m], b[n][0], b[n][1]);
      }
      if (W::kGroups && ++gpos == gq) {
        gpos = 0;
        ++srow;
      }
    }
  }
  cp_async_wait<0>();

  // acc[m][n][2h + e]: column col0 + wcol + 32h + 4g + m, row
  // row0 + wrow + 8n + 2t + e
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + wrow + 8 * n + 2 * t + e;
      if (r >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + wcol + 32 * h + 4 * g;
        if (c >= O) continue;
        float v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) v[m] = acc[m][n][2 * h + e];
        if (split) {
          float* out = ws + ((size_t)blockIdx.z * N + r) * O + c;
          if (VEC) {
            *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int m = 0; m < 4; ++m)
              if (c + m < O) out[m] = v[m];
          }
          continue;
        }
        __nv_bfloat16* out = y + (size_t)r * O + c;
        if (VEC) {
          if (W::kColScale) {
            const float4 sc = *reinterpret_cast<const float4*>(scale + c);
            v[0] *= sc.x;
            v[1] *= sc.y;
            v[2] *= sc.z;
            v[3] *= sc.w;
          }
          __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 pk;
          pk.x = *reinterpret_cast<uint32_t*>(&lo);
          pk.y = *reinterpret_cast<uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(out) = pk;
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (c + m < O)
              out[m] = __float2bfloat16(W::kColScale ? v[m] * scale[c + m] : v[m]);
        }
      }
    }
}

template <class W, int NT, bool VEC>
cudaError_t tile_launch_nt(const __nv_bfloat16* x, const uint8_t* w,
                           const float* scale, __nv_bfloat16* y, float* ws,
                           int N, int K, int O, int group, int wr, int splits,
                           int kps, cudaStream_t s) {
  auto kernel = wonly_tile_kernel<W, NT, VEC>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return attr;
  const int BR = wr * 8 * NT, BO = (4 / wr) * 64;
  const size_t smem = (size_t)kTileStages * tile_stage_bytes<W>(NT, wr);
  dim3 grid((O + BO - 1) / BO, (N + BR - 1) / BR, splits);
  kernel<<<grid, kTileThreads, smem, s>>>(x, w, scale, y, ws, N, K, O, group,
                                          wr, kps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int total = N * O;
  split_sum_kernel<__nv_bfloat16><<<(total + 255) / 256, 256, 0, s>>>(
      ws, y, splits, total, W::kColScale ? scale : nullptr, O);
  return cudaGetLastError();
}

template <class W>
cudaError_t tile_launch_vec(const __nv_bfloat16* x, const uint8_t* w,
                            const float* scale, __nv_bfloat16* y, float* ws,
                            int N, int K, int O, int group, int nt, int wr,
                            int splits, int kps, cudaStream_t s) {
  if (nt == 1)
    return tile_launch_nt<W, 1, true>(x, w, scale, y, ws, N, K, O, group, wr,
                                     splits, kps, s);
  if (nt == 2)
    return tile_launch_nt<W, 2, true>(x, w, scale, y, ws, N, K, O, group, wr,
                                     splits, kps, s);
  return tile_launch_nt<W, 4, true>(x, w, scale, y, ws, N, K, O, group, wr,
                                   splits, kps, s);
}

// The plan (nt n8 tiles a warp, wr warps along the rows, `splits` K splits
// of `kps` K steps each) as ops/quant_matmul.tile_plan gives it; refused
// unless every split is nonempty and together they cover K once.
template <class W>
cudaError_t tile_launch(const __nv_bfloat16* x, const uint8_t* w,
                        const float* scale, __nv_bfloat16* y, float* ws,
                        int N, int K, int O, int group, int nt, int wr,
                        int splits, int kps, cudaStream_t s) {
  const int steps = (K + kTileK - 1) / kTileK;
  if ((nt != 1 && nt != 2 && nt != 4) || (wr != 1 && wr != 2 && wr != 4) ||
      splits < 1 || kps < 1 || (long long)(splits - 1) * kps >= steps ||
      (long long)splits * kps < steps || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const bool vec = O % 16 == 0 && K % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 8 == 0;
  // element loads (ragged shapes, off the serving path) always take 4 n8
  // tiles a warp: one instantiation fewer of each, and the NT = 1 variant
  // spilled
  return vec ? tile_launch_vec<W>(x, w, scale, y, ws, N, K, O, group, nt, wr,
                                  splits, kps, s)
             : tile_launch_nt<W, 4, false>(x, w, scale, y, ws, N, K, O, group,
                                           wr, splits, kps, s);
}

}  // namespace
