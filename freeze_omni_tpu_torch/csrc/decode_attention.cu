// K3 / K4: decode attention over a float KV cache (one query token per row).
//
// Replaces the TPU kernels in freeze_omni_tpu/ops/attention.py:
//   K3 decode_attention (body _kernel), which reads the whole S row of the
//      cache into VMEM;
//   K4 decode_attention_blocked (body _blocked_kernel), which streams only
//      ceil(length / block) blocks of it with an online softmax.
// Built for sm_90a by ops/_build.py and bound with ctypes (ops/attention.py).
//
// Contract: q [B,H,dk] (f32 or bf16); k/v [B,S,Hkv,dk] (f32 or bf16, may be
// wider than q); length int32 [B]. Row b sees slots [0, length[b]) with GQA
// (query head h reads kv head h / (H / Hkv)). out [B,H,dk] in q's dtype. A
// row with length 0 (a masked row) writes zeros.
//
// What bounds it on an H100: bytes. The work is the visible K/V slots,
// sum_b length_b * Hkv * dk * 2 elements read once, against 4 * H * dk
// operations per visible slot: under one operation per byte, far below the
// ~295 the card needs before its arithmetic is the limit.
//
// Design. Pass 1 runs one block per (split of the S axis, kv head, row). A
// split is `split` slots; K4 passes its block size (256 by default), K3 one
// split that covers the whole row. Each block loads the `rep` query heads of
// its kv head once, then walks its split in tiles of 64 slots only up to
// length[b] and never past it: K and V tiles go through shared memory in f32,
// the rep x 64 scores and an online softmax (running max m, sum l) are f32,
// and each thread keeps up to 8 of the rep x dk output accumulators in
// registers. Slots at or past length are never read from device memory: the
// tile's tail is filled with zeros and its scores are -inf by selection, so
// whatever the cache holds there (the scratch slot S-1 collects every masked
// token's K/V; stale rows may hold anything, NaN included) cannot reach the
// result. With one split the block writes the output itself; otherwise it
// writes its partial (m, l, acc) and pass 2 combines the splits that hold
// visible slots. A split that starts at or past length exits at once and is
// never read. Scores and P @ V are f32 SIMT FMAs in this first version;
// tensor cores and asynchronous copies come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int SK = 64;              // cache slots per tile
constexpr int kMaxOut = 1024;       // rep * dk a block can hold
constexpr int kOutPerThread = kMaxOut / kThreads;

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

// four consecutive cache elements as f32 (16-byte or 8-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 c = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// row pitch of the K/V tiles in shared memory: conflict-free float4 reads
template <int DK>
__host__ __device__ constexpr int ldk() { return DK + 4; }

template <int DK>
size_t smem_bytes(int rep) {
  return sizeof(float) * (2 * SK * ldk<DK>() + rep * DK + rep * SK + 3 * rep);
}

template <typename TQ, typename TC, int DK>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                        const TC* __restrict__ v,
                        const int* __restrict__ length, TQ* __restrict__ out,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int H, int Hkv, int S,
                        int split, float sm_scale) {
  constexpr int LDK = ldk<DK>();
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [SK][LDK]
  float* Vs = Ks + SK * LDK;        // [SK][LDK]
  float* Qs = Vs + SK * LDK;        // [rep][DK]
  const int rep = H / Hkv;
  float* Ps = Qs + rep * DK;        // [rep][SK]
  float* m_s = Ps + rep * SK;       // [rep] running max
  float* l_s = m_s + rep;           // [rep] running sum
  float* c_s = l_s + rep;           // [rep] this tile's rescale factor

  const int tid = threadIdx.x;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int len = min(max(length[b], 0), S);
  const int s_begin = sp * split;
  if (nsplit > 1 && s_begin >= len) return;  // no visible slot: never read
  const int s_end = min(s_begin + split, len);
  const int R = rep * DK;

  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * DK;
  for (int i = tid; i < R; i += kThreads) Qs[i] = to_f32(q[q_off + i]);
  if (tid < rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.0f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = s_begin; t0 < s_end; t0 += SK) {
    const int n = min(SK, s_end - t0);
    // K/V tile into shared memory; slots past length are never loaded
    for (int i = tid; i < SK * (DK / 4); i += kThreads) {
      const int s = i / (DK / 4), c = (i % (DK / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (s < n) {
        const size_t off = (((size_t)b * S + t0 + s) * Hkv + hk) * DK + c;
        kv4 = load4(k + off);
        vv4 = load4(v + off);
      }
      *reinterpret_cast<float4*>(Ks + s * LDK + c) = kv4;
      *reinterpret_cast<float4*>(Vs + s * LDK + c) = vv4;
    }
    __syncthreads();

    // scores of the rep heads against the tile's slots
    for (int e = tid; e < rep * SK; e += kThreads) {
      const int r = e / SK, s = e % SK;
      float sc = -INFINITY;
      if (s < n) {
        const float* qr = Qs + r * DK;
        const float* kr = Ks + s * LDK;
        float a = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DK; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          a = fmaf(qv.x, kv.x, a);
          a = fmaf(qv.y, kv.y, a);
          a = fmaf(qv.z, kv.z, a);
          a = fmaf(qv.w, kv.w, a);
        }
        sc = a * sm_scale;
      }
      Ps[r * SK + s] = sc;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int r = warp; r < rep; r += kThreads / 32) {
      const float x0 = Ps[r * SK + lane], x1 = Ps[r * SK + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = lane < n ? expf(x0 - m_new) : 0.0f;
      const float p1 = lane + 32 < n ? expf(x1 - m_new) : 0.0f;
      Ps[r * SK + lane] = p0;
      Ps[r * SK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V over the tile's visible slots
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int o = tid + j * kThreads;
      if (o < R) {
        const int r = o / DK, d = o % DK;
        const float* pr = Ps + r * SK;
        float a = acc[j] * c_s[r];
        for (int s = 0; s < n; ++s) a = fmaf(pr[s], Vs[s * LDK + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

  if (nsplit == 1) {
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int o = tid + j * kThreads;
      if (o < R) {
        const float l = l_s[o / DK];
        out[q_off + o] = from_f32<TQ>(l > 0.0f ? acc[j] / l : 0.0f);
      }
    }
    return;
  }
  const size_t p = ((size_t)b * Hkv + hk) * nsplit + sp;
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int o = tid + j * kThreads;
    if (o < R) part_acc[p * R + o] = acc[j];
  }
  if (tid < rep) {
    part_m[p * rep + tid] = m_s[tid];
    part_l[p * rep + tid] = l_s[tid];
  }
}

// Pass 2 of K4: one block per (head, row) merges the partials of the splits
// that hold visible slots, rescaled to their common maximum.
template <typename TQ, int DK>
__global__ void __launch_bounds__(DK)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ length, TQ* __restrict__ out,
                      int H, int Hkv, int S, int split, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int rep = H / Hkv, hk = h / rep, r = h % rep;
  const int len = min(max(length[b], 0), S);
  const int n_act = (len + split - 1) / split;
  const size_t p0 = ((size_t)b * Hkv + hk) * nsplit;
  float M = -INFINITY;
  for (int i = 0; i < n_act; ++i) M = fmaxf(M, part_m[(p0 + i) * rep + r]);
  float L = 0.0f, a = 0.0f;
  for (int i = 0; i < n_act; ++i) {
    const float w = expf(part_m[(p0 + i) * rep + r] - M);
    L = fmaf(part_l[(p0 + i) * rep + r], w, L);
    a = fmaf(part_acc[((p0 + i) * rep + r) * DK + d], w, a);
  }
  out[((size_t)b * H + h) * DK + d] = from_f32<TQ>(L > 0.0f ? a / L : 0.0f);
}

template <typename TQ, typename TC, int DK>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, void* part_m, void* part_l, void* part_acc, int B,
           int H, int Hkv, int S, int split, int nsplit, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TC, DK>;
  static bool configured = false;  // idempotent, so a race is harmless
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<DK>(kMaxOut / DK)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int rep = H / Hkv;
  dim3 grid(nsplit, Hkv, B);
  kernel<<<grid, kThreads, smem_bytes<DK>(rep), stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const int*>(length),
      static_cast<TQ*>(out), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), H, Hkv, S,
      split, 1.0f / sqrtf(static_cast<float>(DK)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  decode_combine_kernel<TQ, DK><<<dim3(H, B), DK, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(length),
      static_cast<TQ*>(out), H, Hkv, S, split, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch_dk(int dk, const void* q, const void* k, const void* v,
              const void* length, void* out, void* pm, void* pl, void* pa,
              int B, int H, int Hkv, int S, int split, int nsplit,
              cudaStream_t s) {
  if (dk == 64)
    return launch<TQ, TC, 64>(q, k, v, length, out, pm, pl, pa, B, H, Hkv, S,
                              split, nsplit, s);
  if (dk == 128)
    return launch<TQ, TC, 128>(q, k, v, length, out, pm, pl, pa, B, H, Hkv,
                               S, split, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16. dk: 64 or 128; rep * dk <=
// 1024. split: slots per split (>= S for a single split); nsplit =
// ceil(S / split). part_m/part_l [B*Hkv*nsplit*rep] and part_acc
// [B*Hkv*nsplit*rep*dk] f32 scratch, unused when nsplit == 1. Returns the
// cudaError_t of the launches (0 = success). Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int decode_attention_launch(int q_dtype, int kv_dtype,
                                       const void* q, const void* k,
                                       const void* v, const void* length,
                                       void* out, void* part_m, void* part_l,
                                       void* part_acc, int B, int H, int Hkv,
                                       int S, int dk, int split, int nsplit,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || (H / Hkv) * dk > kMaxOut || split <= 0 ||
      nsplit != (S + split - 1) / split)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_dk<float, float>(dk, q, k, v, length, out, part_m, part_l,
                                   part_acc, B, H, Hkv, S, split, nsplit, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_dk<__nv_bfloat16, __nv_bfloat16>(
        dk, q, k, v, length, out, part_m, part_l, part_acc, B, H, Hkv, S,
        split, nsplit, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_dk<__nv_bfloat16, float>(dk, q, k, v, length, out, part_m,
                                           part_l, part_acc, B, H, Hkv, S,
                                           split, nsplit, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_dk<float, __nv_bfloat16>(dk, q, k, v, length, out, part_m,
                                           part_l, part_acc, B, H, Hkv, S,
                                           split, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
