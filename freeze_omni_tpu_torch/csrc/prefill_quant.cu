// K2: int8-KV chunk-prefill attention (GQA).
//
// Replaces the TPU kernel freeze_omni_tpu/ops/attention.py:prefill_quant_pallas
// (body _prefill_quant_kernel). Built for sm_90a by ops/_build.py and bound
// with ctypes (ops/attention.py).
//
// Contract: q [B,T,H,dk] (bf16 or f32); k_q/v_q int8 [B,S,Hkv,dk];
// k_scale/v_scale f32 [B,S,Hkv]; qend int32 [B,T]. Query t of row b sees
// slots [0, qend[b,t]); qend = 0 marks an invalid query, which writes zeros.
// out [B,T,H,dk] in q's dtype. k_scale multiplies the scores and v_scale
// folds into the softmax weights, so the int8 values never need a
// dequantized copy in device memory.
//
// What bounds it on an H100: the bytes are the int8 K/V rows up to each
// row's largest qend (plus q and out); the operations are 4*T*H*dk per
// visible slot. Against 3.35 TB/s and 989 TFLOP/s the serving tick
// (T = 29, H = 28, Hkv = 4) sits near the line between the two.
//
// Design: one block per (row b, kv head, tile of 32 query rows), where the
// query rows are the T x rep (= H/Hkv) queries that share the kv head, so
// each int8 K/V tile read into shared memory serves every one of them. The
// block walks S in tiles of 64 slots only up to the largest qend of its rows
// (never the whole S row, and never slot S-1 when no query can see it),
// with an online softmax in f32. Masked slots are skipped by selection, never
// multiplied by a zero weight: slot S-1 collects every invalid token's K/V
// and its scale may be anything (0 * NaN = NaN). A row whose qend is 0 ends
// with l = 0 and writes zeros. Scores and the P @ V product are f32 SIMT
// FMAs in this first version; tensor cores come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int QT = 32;  // query rows per block (8 threads per row)
constexpr int SK = 64;  // cache slots per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
prefill_quant_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                     const float* __restrict__ ks,
                     const int8_t* __restrict__ vq,
                     const float* __restrict__ vs,
                     const int* __restrict__ qend, T* __restrict__ out,
                     int T_len, int H, int Hkv, int S, float sm_scale) {
  constexpr int LDK = DK + 4;     // row pitch: floats in Qs, bytes in Ks/Vs
  constexpr int COLS = DK / 8;    // output columns per thread
  __shared__ __align__(16) float Qs[QT * LDK];
  __shared__ __align__(16) int8_t Ks[SK * LDK];
  __shared__ __align__(16) int8_t Vs[SK * LDK];
  __shared__ float Ksc[SK];
  __shared__ float Vsc[SK];
  __shared__ float Ps[QT * (SK + 1)];
  __shared__ int qe_s[QT];
  __shared__ int smax_s;

  const int tid = threadIdx.x;
  const int r = tid >> 3;   // query row of this thread within the tile
  const int sub = tid & 7;  // lane within the row's group of 8
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int rep = H / Hkv;
  const int M = T_len * rep;
  const int m0 = blockIdx.x * QT;

  for (int i = tid; i < QT * DK; i += kThreads) {
    const int rr = i / DK, d = i % DK;
    const int m = m0 + rr;
    float v = 0.0f;
    if (m < M) {
      const int t = m / rep, j = m % rep;
      v = to_f32(q[(((size_t)b * T_len + t) * H + hk * rep + j) * DK + d]);
    }
    Qs[rr * LDK + d] = v;
  }
  if (tid == 0) smax_s = 0;
  if (tid < QT) {
    const int m = m0 + tid;
    int e = 0;
    if (m < M) e = min(max(qend[(size_t)b * T_len + m / rep], 0), S);
    qe_s[tid] = e;
  }
  __syncthreads();
  if (tid < QT) atomicMax(&smax_s, qe_s[tid]);
  __syncthreads();
  const int smax = smax_s;
  const int my_qe = qe_s[r];

  float m_run = -INFINITY;
  float l_run = 0.0f;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;

  for (int s0 = 0; s0 < smax; s0 += SK) {
    for (int i = tid; i < SK * (DK / 4); i += kThreads) {
      const int s = i / (DK / 4), c = (i % (DK / 4)) * 4;
      const int gs = s0 + s;
      char4 k4 = make_char4(0, 0, 0, 0), v4 = make_char4(0, 0, 0, 0);
      if (gs < smax) {
        const size_t off = (((size_t)b * S + gs) * Hkv + hk) * DK + c;
        k4 = *reinterpret_cast<const char4*>(kq + off);
        v4 = *reinterpret_cast<const char4*>(vq + off);
      }
      *reinterpret_cast<char4*>(Ks + s * LDK + c) = k4;
      *reinterpret_cast<char4*>(Vs + s * LDK + c) = v4;
    }
    if (tid < SK) {
      const int gs = s0 + tid;
      const size_t off = ((size_t)b * S + gs) * Hkv + hk;
      Ksc[tid] = gs < smax ? ks[off] : 0.0f;
      Vsc[tid] = gs < smax ? vs[off] : 0.0f;
    }
    __syncthreads();

    // scores of this thread's 8 slots: sub, sub + 8, ..., sub + 56
    float sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.0f;
    const float* qrow = Qs + r * LDK;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const char4 kv = *reinterpret_cast<const char4*>(
            Ks + (sub + 8 * j) * LDK + d);
        sc[j] = fmaf(qv.x, (float)kv.x, sc[j]);
        sc[j] = fmaf(qv.y, (float)kv.y, sc[j]);
        sc[j] = fmaf(qv.z, (float)kv.z, sc[j]);
        sc[j] = fmaf(qv.w, (float)kv.w, sc[j]);
      }
    }

    bool valid[8];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = sub + 8 * j;
      valid[j] = (s0 + s) < my_qe;
      sc[j] = valid[j] ? sc[j] * Ksc[s] * sm_scale : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m_run, tmax);

    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = sub + 8 * j;
      const float p = valid[j] ? expf(sc[j] - m_new) : 0.0f;
      psum += p;
      Ps[r * (SK + 1) + s] = valid[j] ? p * Vsc[s] : 0.0f;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float corr = (m_run == -INFINITY) ? 0.0f : expf(m_run - m_new);
    l_run = l_run * corr + psum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= corr;
    __syncwarp();

    const float* prow = Ps + r * (SK + 1);
    const int8_t* vcol = Vs + sub * COLS;
    for (int s = 0; s < SK; ++s) {
      const float p = prow[s];
#pragma unroll
      for (int c = 0; c < COLS; c += 4) {
        const char4 v4 = *reinterpret_cast<const char4*>(vcol + s * LDK + c);
        acc[c] = fmaf(p, (float)v4.x, acc[c]);
        acc[c + 1] = fmaf(p, (float)v4.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, (float)v4.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, (float)v4.w, acc[c + 3]);
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

  const int m = m0 + r;
  if (m < M) {
    const int t = m / rep, j = m % rep;
    T* orow = out + (((size_t)b * T_len + t) * H + hk * rep + j) * DK +
              sub * COLS;
    const float inv = l_run > 0.0f ? 1.0f / l_run : 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) orow[c] = from_f32<T>(acc[c] * inv);
  }
}

template <typename T, int DK>
void launch(const void* q, const void* kq, const void* ks, const void* vq,
            const void* vs, const void* qend, void* out, int B, int T_len,
            int H, int Hkv, int S, cudaStream_t stream) {
  const int rep = H / Hkv;
  dim3 grid((T_len * rep + QT - 1) / QT, Hkv, B);
  prefill_quant_kernel<T, DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(qend),
      static_cast<T*>(out), T_len, H, Hkv, S, 1.0f / sqrtf((float)DK));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). dk: 64 or 128. Returns the
// cudaError_t of the launch (0 = success). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int prefill_quant_launch(int dtype, const void* q, const void* kq,
                                    const void* ks, const void* vq,
                                    const void* vs, const void* qend,
                                    void* out, int B, int T_len, int H,
                                    int Hkv, int S, int dk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dk == 128)
    launch<float, 128>(q, kq, ks, vq, vs, qend, out, B, T_len, H, Hkv, S, s);
  else if (dtype == 0 && dk == 64)
    launch<float, 64>(q, kq, ks, vq, vs, qend, out, B, T_len, H, Hkv, S, s);
  else if (dtype == 1 && dk == 128)
    launch<__nv_bfloat16, 128>(q, kq, ks, vq, vs, qend, out, B, T_len, H, Hkv,
                               S, s);
  else if (dtype == 1 && dk == 64)
    launch<__nv_bfloat16, 64>(q, kq, ks, vq, vs, qend, out, B, T_len, H, Hkv,
                              S, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
