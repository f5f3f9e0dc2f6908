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
// wider than q), dk 32 (the tiny speech decoder), 64 or 128; length int32
// [B]. Row b sees slots [0, length[b]) with GQA
// (query head h reads kv head h / (H / Hkv)). out [B,H,dk] in q's dtype. A
// row with length 0 (a masked row) writes zeros.
//
// What bounds it on an H100: bytes. The work is the visible K/V slots,
// sum_b length_b * Hkv * dk * 2 elements read once, against 4 * H * dk
// operations per visible slot: 0.5 operations a byte for the speech
// decoder (f32, one query head a kv head), 7 for the LLM's bf16 GQA, far
// below the ~295 the card needs before its arithmetic is the limit. So
// tensor cores would buy nothing (and TF32 would break f32 parity): the
// design is about bytes in flight, balanced blocks and busy threads.
//
// The plan (ops/attention.decode_plan, from the shapes alone): `splits`
// blocks a (row, kv head), about one block on each of the 132 SMs. With
// each warp keeping its own copies in flight, one block an SM streams at
// about the card's rate, and more splits cost more in partials and the
// merge pass than they gain (bin/k4_profile.py); the speech decoder's 8
// rows of 14 kv heads take one split and no merge. Only the card knows
// length, so each block cuts its own share of [0, length) in whole tiles
// of kTile slots, spread evenly (SplitCut, as K2's): every block that runs
// has visible slots and no two shares differ by more than one tile; blocks
// past the row's tiles exit at once. K3 is the same kernel with one split:
// one block a (row, kv head) walks every visible slot, writes the output
// itself and needs no workspace.
//
// The block: 4 warps, each an independent stream. Warp w takes slots
// [8w, 8w + 8) of each of the block's tiles and keeps its own ring of
// kStages sub-tiles (its 8 K and V rows) filled by 16-byte cp.async, so
// the next sub-tiles are in flight while the current one is scored; no
// block barrier until the end. Slots at or past length are never copied:
// their rows are zero-filled (cp.async with source size 0) and their
// scores set to -inf by selection, so whatever the cache holds there
// (scratch slot S-1 collects every masked token's K/V; stale rows may hold
// NaN) cannot reach the result. Scores: 4 lanes a slot, each a quarter of
// dk (K rows of 8 or more 16-byte chunks swizzled so a quarter-warp's loads
// hit distinct banks; a 4-chunk row, bf16 at dk 32, is conflict-free
// unswizzled), summed by two shuffles; an online softmax in base 2 per
// warp and head (m, l in registers); P @ V with each lane owning dk / 32
// output columns of every query head, so all 32 lanes work at one query
// head a kv head. Math is f32 FMAs; bf16 converts in registers. At the end
// the 4 warps' (m, l, acc) merge through shared memory. With one split the
// block writes the output; otherwise its partial goes to the workspace and
// decode_merge_kernel (a warp a (row, head), a lane a split) combines the
// splits that hold visible slots in a fixed order: bit-identical calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpSlots = 8;                 // slots a warp takes of a tile
constexpr int kTile = kWarps * kWarpSlots;    // 32: the unit of the split cut
constexpr int kStages = 3;                    // sub-tiles in a warp's ring
constexpr int kMaxOut = 1024;                 // rep * dk a block can hold
constexpr int kMaxRepAny = 16;                // query heads a kv head, any dk
constexpr int kMaxSplits = 32;                // a lane a split in the merge
constexpr unsigned kFull = 0xffffffffu;

// the cache's geometry in 16-byte chunks
template <typename TC, int DK>
struct Geo {
  static constexpr int kRowBytes = DK * static_cast<int>(sizeof(TC));
  static constexpr int kChunks = kRowBytes / 16;         // 4, 8, 16 or 32
  static constexpr int kElems = 16 / static_cast<int>(sizeof(TC));
  static constexpr int kLaneChunks = kChunks / 4;        // a lane's quarter
  static constexpr int kSwizzle = kChunks >= 8 ? 4 : 0;  // flips bit 2, odd slots
  static constexpr int kWarpStage = 2 * kWarpSlots * kRowBytes;   // K + V
  static constexpr int kRing = kStages * kWarps * kWarpStage;
  static constexpr int kMaxRep = kMaxOut / DK < kMaxRepAny ? kMaxOut / DK
                                                           : kMaxRepAny;
  static constexpr int kOut = DK / 32;                    // columns a lane owns
  static_assert(kChunks >= 4, "4 lanes a slot, a chunk or more each");
  static_assert(kWarps * kMaxRep * (DK + 2) * 4 <= kRing,
                "the warps' partials reuse the ring");
};

// the ring, then the query heads in f32, padded with zero heads to MR
template <typename TC, int DK>
size_t smem_bytes(int MR) {
  return Geo<TC, DK>::kRing + sizeof(float) * MR * DK;
}

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

// one 16-byte chunk of a cache row as f32
__device__ __forceinline__ void chunk_f32(const float* p, float (&o)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p,
                                          float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// a lane's N consecutive columns of a V row as f32 (N = 1, 2 or 4)
template <int N>
__device__ __forceinline__ void cols_f32(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    o[0] = u.x; o[1] = u.y;
  } else {
    o[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void cols_f32(const __nv_bfloat16* p,
                                         float (&o)[N]) {
  if constexpr (N == 1) {
    o[0] = __bfloat162float(*p);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      o[i] = f.x;
      o[i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The split of a row's visible slots: its ceil(len / kTile) tiles go to
// min(splits, tiles) blocks, block sp taking tiles [first(sp), first(sp+1)).
struct SplitCut {
  int ntiles, used;
  __device__ SplitCut(int len, int splits)
      : ntiles((len + kTile - 1) / kTile), used(min(splits, ntiles)) {}
  __device__ int first(int sp) const { return sp * ntiles / used; }
};

// MR: the query heads a kv head the registers hold, rep rounded up to 1, 8
// or 16; the heads past rep are zero queries, scored and dropped, so the
// loops over heads have no branches and their shuffle chains interleave
template <typename TQ, typename TC, int DK, int MR>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
              const TC* __restrict__ v, const int* __restrict__ length,
              TQ* __restrict__ out, float* __restrict__ ws, int H, int Hkv,
              int S, int splits, float scale_log2) {
  using G = Geo<TC, DK>;
  constexpr int NO = G::kOut;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + G::kRing);   // [rep][DK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int len = min(max(length[b], 0), S);
  const SplitCut cut(len, splits);
  if (splits > 1 && sp >= cut.used) return;   // no visible slot: never read
  const int t_begin = cut.used ? cut.first(sp) : 0;
  const int t_end = cut.used ? cut.first(sp + 1) : 0;
  const int s_end = min(t_end * kTile, len);
  const int n_sub = t_end - t_begin;           // this warp's sub-tiles

  const size_t q_off = ((size_t)b * H + (size_t)hk * rep) * DK;
  for (int i = tid; i < MR * DK; i += kThreads)
    Qs[i] = i < rep * DK ? to_f32(q[q_off + i]) : 0.0f;

  const size_t row_stride = (size_t)Hkv * DK;   // one slot to the next
  const TC* kb = k + (size_t)b * S * row_stride + (size_t)hk * DK;
  const TC* vb = v + (size_t)b * S * row_stride + (size_t)hk * DK;
  auto stage_ptr = [&](int st) {
    return smem + (st * kWarps + warp) * G::kWarpStage;
  };
  auto sub_start = [&](int i) { return (t_begin + i) * kTile + warp * kWarpSlots; };
  // sub-tile i into stage st: K rows swizzled (chunk c of slot s at
  // c ^ kSwizzle for odd s), V rows plain; slots past s_end zero-filled
  auto load = [&](int i, int st) {
    const int s0 = sub_start(i);
    if (s0 >= s_end) return;
    unsigned char* Ks = stage_ptr(st);
    unsigned char* Vs = Ks + kWarpSlots * G::kRowBytes;
#pragma unroll
    for (int it = 0; it < kWarpSlots * G::kChunks / 32; ++it) {
      const int c = lane + 32 * it;
      const int s = c / G::kChunks, ch = c % G::kChunks;
      const bool ok = s0 + s < s_end;
      const size_t g = (size_t)(ok ? s0 + s : 0) * row_stride + ch * G::kElems;
      cp_async16(Ks + s * G::kRowBytes + ((ch ^ ((s & 1) * G::kSwizzle)) * 16),
                 kb + g, ok);
      cp_async16(Vs + s * G::kRowBytes + ch * 16, vb + g, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_sub) load(i, i);
    cp_async_commit();
  }
  __syncthreads();   // Qs

  float m[MR], l[MR], acc[MR][NO];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[r][o] = 0.0f;
  }
  const int my = lane >> 2, part = lane & 3;   // scoring: slot, quarter of dk

  for (int i = 0; i < n_sub; ++i) {
    if (i + kStages - 1 < n_sub) load(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int s0 = sub_start(i);
    if (s0 < s_end) {   // warp-uniform
      const int n = min(kWarpSlots, s_end - s0);
      const bool valid = my < n;
      const unsigned char* Ks = stage_ptr(i % kStages);
      const TC* Vs = reinterpret_cast<const TC*>(Ks + kWarpSlots * G::kRowBytes);
      float kf[G::kLaneChunks][G::kElems];
#pragma unroll
      for (int j = 0; j < G::kLaneChunks; ++j) {
        const int ch = (part + 4 * j) ^ ((my & 1) * G::kSwizzle);
        chunk_f32(reinterpret_cast<const TC*>(Ks + my * G::kRowBytes + ch * 16),
                  kf[j]);
      }
      float p[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float* qr = Qs + r * DK;
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < G::kLaneChunks; ++j) {
          const float* qc = qr + (part + 4 * j) * G::kElems;
#pragma unroll
          for (int e = 0; e < G::kElems; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qc + e);
            a = fmaf(q4.x, kf[j][e], a);
            a = fmaf(q4.y, kf[j][e + 1], a);
            a = fmaf(q4.z, kf[j][e + 2], a);
            a = fmaf(q4.w, kf[j][e + 3], a);
          }
        }
        a += __shfl_xor_sync(kFull, a, 1);
        a += __shfl_xor_sync(kFull, a, 2);
        const float sc = valid ? a * scale_log2 : -INFINITY;
        float mt = fmaxf(sc, __shfl_xor_sync(kFull, sc, 4));
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 16));
        const float m_new = fmaxf(m[r], mt);   // finite: slot 0 is visible
        const float pr = valid ? exp2f(sc - m_new) : 0.0f;
        float sum = pr + __shfl_xor_sync(kFull, pr, 4);
        sum += __shfl_xor_sync(kFull, sum, 8);
        sum += __shfl_xor_sync(kFull, sum, 16);
        const float corr = exp2f(m[r] - m_new);   // 0 while m is -inf
        l[r] = l[r] * corr + sum;
        m[r] = m_new;
#pragma unroll
        for (int o = 0; o < NO; ++o) acc[r][o] *= corr;
        p[r] = pr;
      }
      // acc += P @ V over the sub-tile's visible slots
      for (int j = 0; j < n; ++j) {
        float vv[NO];
        cols_f32<NO>(Vs + j * DK + lane * NO, vv);
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const float pj = __shfl_sync(kFull, p[r], 4 * j);
#pragma unroll
          for (int o = 0; o < NO; ++o) acc[r][o] = fmaf(pj, vv[o], acc[r][o]);
        }
      }
    }
    __syncwarp();   // the next load refills this stage
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: it holds the partials

  float* Pm = reinterpret_cast<float*>(smem);   // [kWarps][rep]
  float* Pl = Pm + kWarps * rep;                 // [kWarps][rep]
  float* Pa = Pl + kWarps * rep;                 // [kWarps][rep][DK]
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r < rep) {
      if (lane == 0) {
        Pm[warp * rep + r] = m[r];
        Pl[warp * rep + r] = l[r];
      }
#pragma unroll
      for (int o = 0; o < NO; ++o)
        Pa[(warp * rep + r) * DK + lane * NO + o] = acc[r][o];
    }
  }
  __syncthreads();

  const size_t n_part = (size_t)gridDim.z * Hkv * splits * rep;
  const size_t p0 = (((size_t)b * Hkv + hk) * splits + sp) * rep;
  for (int o = tid; o < rep * DK; o += kThreads) {
    const int r = o / DK, d = o % DK;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Pm[w * rep + r]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = Pm[w * rep + r];
      const float wt = mw == -INFINITY ? 0.0f : exp2f(mw - M);
      L = fmaf(Pl[w * rep + r], wt, L);
      A = fmaf(Pa[(w * rep + r) * DK + d], wt, A);
    }
    if (splits == 1) {
      out[q_off + o] = from_f32<TQ>(L > 0.0f ? A / L : 0.0f);
    } else {
      ws[(p0 + r) * DK + d] = A;
      if (d == 0) {
        ws[n_part * DK + p0 + r] = M;
        ws[n_part * (DK + 1) + p0 + r] = L;
      }
    }
  }
}

// Pass 2 of K4: a warp a (row, head) merges the partials of the splits that
// hold visible slots (a lane a split for m and l), rescaled to their common
// maximum, in split order.
template <typename TQ, int DK>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ ws,
                    const int* __restrict__ length, TQ* __restrict__ out,
                    int B, int H, int Hkv, int S, int splits) {
  constexpr int NO = DK / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);   // b * H + h
  if (row >= B * H) return;
  const int b = row / H, h = row % H, rep = H / Hkv;
  const int len = min(max(length[b], 0), S);
  const SplitCut cut(len, splits);
  const size_t n_part = (size_t)B * Hkv * splits * rep;
  const size_t p0 = ((size_t)b * Hkv + h / rep) * splits * rep + h % rep;
  const bool mine = lane < cut.used;
  const float mi = mine ? ws[n_part * DK + p0 + lane * rep] : -INFINITY;
  const float M = warp_max(mi);
  const float wi = mine ? exp2f(mi - M) : 0.0f;
  const float L = warp_sum(mine ? ws[n_part * (DK + 1) + p0 + lane * rep] * wi
                                : 0.0f);
  float a[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) a[o] = 0.0f;
  for (int i = 0; i < cut.used; ++i) {
    const float w = __shfl_sync(kFull, wi, i);
    float pa[NO];
    cols_f32<NO>(ws + (p0 + (size_t)i * rep) * DK + lane * NO, pa);
#pragma unroll
    for (int o = 0; o < NO; ++o) a[o] = fmaf(pa[o], w, a[o]);
  }
#pragma unroll
  for (int o = 0; o < NO; ++o)
    out[(size_t)row * DK + lane * NO + o] = from_f32<TQ>(L > 0.0f ? a[o] / L : 0.0f);
}

template <typename TQ, typename TC, int DK, int MR>
cudaError_t launch_main(const void* q, const void* k, const void* v,
                        const void* length, void* out, void* ws, int B, int H,
                        int Hkv, int S, int splits, cudaStream_t stream) {
  auto kernel = decode_kernel<TQ, TC, DK, MR>;
  static bool configured = false;  // idempotent, so a race is harmless
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<TC, DK>(MR)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(DK));
  kernel<<<dim3(splits, Hkv, B), kThreads, smem_bytes<TC, DK>(MR), stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const int*>(length),
      static_cast<TQ*>(out), static_cast<float*>(ws), H, Hkv, S, splits,
      scale_log2);
  return cudaGetLastError();
}

template <typename TQ, typename TC, int DK>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, void* ws, int B, int H, int Hkv, int S, int splits,
           cudaStream_t stream) {
  const int rep = H / Hkv;
  cudaError_t e;
  if (rep == 1)
    e = launch_main<TQ, TC, DK, 1>(q, k, v, length, out, ws, B, H, Hkv, S,
                                   splits, stream);
  else if (rep <= 8)
    e = launch_main<TQ, TC, DK, 8>(q, k, v, length, out, ws, B, H, Hkv, S,
                                   splits, stream);
  else
    e = launch_main<TQ, TC, DK, Geo<TC, DK>::kMaxRep>(
        q, k, v, length, out, ws, B, H, Hkv, S, splits, stream);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  decode_merge_kernel<TQ, DK><<<(B * H + kWarps - 1) / kWarps, kThreads, 0,
                                stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(length),
      static_cast<TQ*>(out), B, H, Hkv, S, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int launch_dk(int dk, const void* q, const void* k, const void* v,
              const void* length, void* out, void* ws, int B, int H, int Hkv,
              int S, int splits, cudaStream_t s) {
  if (dk == 32)
    return launch<TQ, TC, 32>(q, k, v, length, out, ws, B, H, Hkv, S, splits, s);
  if (dk == 64)
    return launch<TQ, TC, 64>(q, k, v, length, out, ws, B, H, Hkv, S, splits, s);
  if (dk == 128)
    return launch<TQ, TC, 128>(q, k, v, length, out, ws, B, H, Hkv, S, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16. dk: 32, 64 or 128; rep =
// H / Hkv <= 16 and rep * dk <= 1024. splits: blocks a (row, kv head), 1..32 (1: K3's single pass, no
// merge, ws unused). ws: B*Hkv*splits*rep*(dk+2) f32 of split partials
// (acc, then m, then l). Returns the cudaError_t of the launches (0 =
// success). Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int decode_attention_launch(int q_dtype, int kv_dtype,
                                       const void* q, const void* k,
                                       const void* v, const void* length,
                                       void* out, void* ws, int B, int H,
                                       int Hkv, int S, int dk, int splits,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || (H / Hkv) * dk > kMaxOut ||
      H / Hkv > kMaxRepAny || splits < 1 ||
      splits > kMaxSplits || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_dk<float, float>(dk, q, k, v, length, out, ws, B, H, Hkv, S,
                                   splits, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_dk<__nv_bfloat16, __nv_bfloat16>(dk, q, k, v, length, out, ws,
                                                   B, H, Hkv, S, splits, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_dk<__nv_bfloat16, float>(dk, q, k, v, length, out, ws, B, H,
                                           Hkv, S, splits, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_dk<float, __nv_bfloat16>(dk, q, k, v, length, out, ws, B, H,
                                           Hkv, S, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
