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
// dequantized copy in device memory. Masked slots are removed by selection
// (score -inf, weight 0), never multiplied by a zero weight: slot S-1
// collects every invalid token's K/V and its scale may be anything (0 * NaN
// = NaN).
//
// What bounds it on an H100: the bytes, the int8 K/V rows up to each row's
// largest qend (264 bytes a slot and kv head with the scales) plus q and
// out; the operations are 4*H*dk per visible slot and valid query. At the
// serving tick (B = 8, T = 29 of which 8 are valid, ~545 visible slots) that
// is ~4.6 MB against ~0.5 GFLOP: bytes, ~2.4 us.
//
// bf16 q (every card path) takes prefill_tc_kernel, on the tensor cores:
//
// - Compacted query rows. The query rows of one (row b, kv head) are
//   rank(t) * rep + j over the tokens t with qend[b, t] > 0 (j the query
//   head within the kv head), found by warp 0 from qend[b, :T] with a
//   ballot scan (RowMap), so the host never reads qend. They are cut into
//   row tiles of 16, 32 or 64 rows (1, 2 or 4 warps, ops/attention.
//   prefill_plan; warp w owns rows 16w..16w+15), and every int8 K/V tile a
//   block loads serves all of a tile's rows. A tick's 8 valid tokens of 29
//   give 56 rows, one tile of 64; the text step's 7 rows one tile of 16.
// - Split S, sized on the device. Grid (splits, b * Hkv): once a block
//   knows its row's valid rows, the (row tile, split) units of (b, kv head)
//   are dealt out over the `splits` blocks, each non-empty row tile taking
//   min(tile_splits, max(1, splits / tiles)) splits (tile_splits_of), so
//   no block is spent on a row tile with no valid row. tile_splits is 1
//   where T * rep rows, all valid, would leave one split a row tile (the
//   role prefill): then no call needs the merge pass or the workspace, and
//   neither is launched or reserved. A split takes a run of whole 64-slot
//   tiles of [0, qmax), qmax being the row tile's largest qend (SplitCut),
//   so every split that runs has visible slots and nothing past qmax is
//   read. A row tile with one split writes the output itself; otherwise
//   each split writes its rows' partial (m, l, acc) to the workspace, and
//   prefill_merge_kernel adds, for each row, the splits that hold visible
//   slots of that row in a fixed order (bit-identical calls, no atomics).
// - mma.sync m16n8k16, f32 accumulators, the online softmax in registers
//   (FlashAttention-2's layout). The queries are the A operand: the score
//   accumulator of Q K^T is then exactly the A fragment of P for P V, so P
//   never leaves registers. Swap-AB (cache as A, queries as n8) would fit
//   the text step's 7 rows into one n8 tile instead of an m16 tile with 9
//   idle rows, but P would need a transpose through shared memory or
//   shuffles every tile; the idle rows cost mma issue slots, which the text
//   step (bound by its K/V bytes) has to spare, and no bytes.
//   * Q K^T: bf16 q against K converted exactly from int8 to bf16. dk is
//     permuted (the dot is a sum over dk): lane (g, t) holds dk
//     [t*dk/4, (t+1)*dk/4) of its rows and of slot g, and k step ks takes
//     bytes 4ks..4ks+3 of that run, so one 16-byte shared load gives a
//     lane its K fragments of 4 (dk 64) or 2 (dk 128) k steps. Scores are
//     exact products summed in f32, times k_scale and log2(e)/sqrt(dk).
//   * P V: P = softmax weight * v_scale, rounded to f16 (the one new
//     rounding): f16 keeps 3 more bits than bf16, and p * v_scale <=
//     v_scale cannot overflow it (a v_scale over 65504 would mean |v| near
//     8e6); terms below f16's subnormals (~6e-8) flush to 0. V converts
//     exactly from int8 to f16. The output columns are permuted so that a
//     lane's 16-byte load of one slot's V row feeds dk/8 n8 tiles and the
//     lane ends with dk [t*dk/4, (t+1)*dk/4) of its rows: 16-byte stores.
//   * int8 to bf16/f16 exactly without f32, two values a register: K's
//     low 7 bits go into the mantissa of bf16 128.0 and the sign bit into
//     the subtrahend (as csrc/quant_matmul.cu's i8_pair: prmt, two lop3,
//     hsub2); V's byte b, as b ^ 0x80 = b + 128, into the mantissa of f16
//     1024.0, minus 1152 (prmt, lop3, hsub2).
// - The copy path: a 3-stage ring of 64-slot tiles (int8 K and V rows of
//   the kv head, 16-byte cp.async, zero-filled past the split; their f32
//   scales, 4-byte cp.async), one __syncthreads a tile. Shared rows are
//   padded (144 bytes at dk 128) so that the 16-byte fragment loads of a
//   quarter-warp hit distinct banks.
//
// f32 q (no card path runs it at full width) keeps the first version's
// SIMT kernel (prefill_quant_kernel): one block per (row b, kv head, tile of
// 32 query rows) walks S in 64-slot tiles up to the largest qend of its rows
// with an online softmax in f32, scores and P @ V on f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wonly_tile.cuh"   // cp_async16, cp_async_commit/wait, mma_bf16

namespace {

// ---- f32 q: the SIMT kernel -------------------------------------------------
constexpr int kThreads = 256;
constexpr int QT = 32;  // query rows per block (8 threads per row)
constexpr int SK = 64;  // cache slots per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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
void launch_simt(const void* q, const void* kq, const void* ks, const void* vq,
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

// ---- bf16 q: the tensor-core kernel ----------------------------------------

constexpr int kTileS = 64;      // cache slots a tile (ops/attention.PREFILL_TILE)
constexpr int kStages = 3;      // ring stages: 2 tiles in flight while 1 is summed
constexpr int kMaxSplits = 32;  // the merge takes a split a lane

template <int DK>
struct TcGeo {
  static constexpr int KSTR = DK == 128 ? 144 : 64;   // bytes a staged K row
  static constexpr int VSTR = DK == 128 ? 144 : 80;   // and V row
  static constexpr int STAGE = kTileS * (KSTR + VSTR) + 2 * kTileS * 4;
  static constexpr int SMEM = kStages * STAGE;
  static constexpr int KS = DK / 16;   // k16 steps of Q K^T
  static constexpr int ND = DK / 8;    // n8 tiles of P V
};

// The splits each non-empty row tile of a (b, kv head) takes, from its
// valid query rows: the `splits` blocks shared out over its row tiles, at
// most tile_splits each. Both kernels read it, so they agree on the units.
__device__ __forceinline__ int tile_splits_of(int rows, int rt, int splits,
                                              int tile_splits) {
  const int tiles = (rows + rt - 1) / rt;
  return min(tile_splits, max(1, splits / max(tiles, 1)));
}

// How a row tile's visible slots [0, qmax) are cut: its ntiles = ceil(qmax
// / 64) tiles go to used = min(splits, ntiles) splits, split sp taking tiles
// [sp * ntiles / used, (sp + 1) * ntiles / used), at least one each. A row
// whose qend is qe sees the first ceil(ceil(qe / 64) * used / ntiles) of
// them (the merge adds those).
struct SplitCut {
  int ntiles, used;
  __device__ SplitCut(int qmax, int splits)
      : ntiles((qmax + kTileS - 1) / kTileS), used(min(splits, ntiles)) {}
  __device__ int first(int sp) const { return sp * ntiles / used; }
  __device__ int seen_by(int qe) const {
    return ((qe + kTileS - 1) / kTileS * used + ntiles - 1) / ntiles;
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bytes (0, 1) or (2, 3) of one word: a K fragment register (two dk of a
// slot) as an exact bf16 pair, byte 0 or 2 in the low half. bf16 keeps 7
// mantissa bits: the low 7 bits go into the mantissa of 128.0 (0x4300),
// minus 128 + 128 * sign (the sign bit into the exponent); one prmt, two
// lop3 and one hsub2.
__device__ __forceinline__ uint32_t k_pair(uint32_t w, int hi) {
  const uint32_t r = __byte_perm(w, 0, hi ? 0x3322 : 0x1100);
  uint32_t v = (r & 0x007F007Fu) | 0x43004300u;
  uint32_t s = (r & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   *reinterpret_cast<__nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&d);
}
// byte j of w0 and of w1: a V fragment register (one dk of slots s, s + 1)
// as an exact f16 pair. f16's 10-bit mantissa takes the byte whole: b ^
// 0x80 = b + 128 (0..255) into the mantissa of 1024.0, minus 1152; one
// prmt, one lop3 and one hsub2.
__device__ __forceinline__ uint32_t v_pair(uint32_t w0, uint32_t w1, int j) {
  uint32_t v = (__byte_perm(w0, w1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)) &
                0x00FF00FFu) ^ 0x64806480u;
  const __half2 d = __hsub2(*reinterpret_cast<__half2*>(&v),
                            __half2half2(__ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&d);
}

template <int NW>
__device__ __forceinline__ void load_words(uint32_t (&w)[NW], const void* p) {
  static_assert(NW == 2 || NW % 4 == 0, "8 or 16k bytes");
  if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t f16x2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The compacted query rows [r0, r0 + RT) of row b: the valid tokens of
// ranks k0 = r0 / rep .. (their token and clamped qend), the number of rows
// in the tile and their largest qend, and the valid tokens of the row in
// all. build() runs on warp 0.
template <int RT>
struct RowMap {
  int tok[RT + 1];
  int qe[RT + 1];
  int n, qmax, valid;

  __device__ void build(const int* __restrict__ qend_b, int T, int S, int rep,
                        int r0) {
    const int lane = threadIdx.x;
    const int k0 = r0 / rep, k1 = (r0 + RT - 1) / rep + 1;
    int base = 0;   // valid tokens before t0
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const int e = t < T ? min(qend_b[t], S) : 0;
      const unsigned bal = __ballot_sync(0xffffffffu, e > 0);
      const int k = base + __popc(bal & ((1u << lane) - 1u));
      if (e > 0 && k >= k0 && k < k1) {
        tok[k - k0] = t;
        qe[k - k0] = e;
      }
      base += __popc(bal);
    }
    const int rows = min(RT, max(0, base * rep - r0));
    __syncwarp();
    int mx = 0;
    if (rows > 0)
      for (int i = lane; i <= (r0 + rows - 1) / rep - k0; i += 32)
        mx = max(mx, qe[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) {
      n = rows;
      qmax = mx;
      valid = base;
    }
  }
};

// Grid (splits, b * Hkv); 32 * W threads, warp w owning compacted rows
// 16w..16w+15 of a row tile. The (row tile, split) units of a (b, kv
// head) are dealt out over its `splits` blocks once the valid rows are
// known: with nt non-empty row tiles, each takes min(tile_splits,
// max(1, splits / nt)) splits (the tick and the text step: one row tile,
// `splits` splits; the role prefill at B = 8: ten row tiles, one split
// each, a block walking two). A unit with one split writes the output;
// otherwise its partial goes to unit u's slot of part_acc/part_ml
// [b * Hkv, splits, RT] x (dk | m, l).
template <int DK, int W>
__global__ void __launch_bounds__(32 * W)
prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const int8_t* __restrict__ kq, const float* __restrict__ ks,
                  const int8_t* __restrict__ vq, const float* __restrict__ vs,
                  const int* __restrict__ qend,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int T, int H, int Hkv, int S, int tile_splits,
                  float qk_scale) {
  using G = TcGeo<DK>;
  constexpr int RT = 16 * W, NT = 32 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RowMap<RT> rm;
  const int splits = gridDim.x, bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int rep = H / Hkv, M = T * rep;
  const int* qend_b = qend + (size_t)b * T;

  // zeros for the invalid queries of (b, hk), dealt out over the blocks
  for (int i = blockIdx.x * NT + threadIdx.x; i < M * (DK / 8); i += splits * NT) {
    const int m = i / (DK / 8), t = m / rep;
    if (min(qend_b[t], S) <= 0)
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * T + t) * H + hk * rep + m % rep) * DK +
          (i % (DK / 8)) * 8) = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x < 32) rm.build(qend_b, T, S, rep, 0);
  __syncthreads();
  const int tiles = (rm.valid * rep + RT - 1) / RT;
  const int per_tile = tile_splits_of(rm.valid * rep, RT, splits, tile_splits);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  int cur = 0;   // the row tile in rm
  for (int u = blockIdx.x; u < tiles * per_tile; u += splits) {
    const int rt = u / per_tile, sp = u % per_tile, r0 = rt * RT;
    if (rt != cur) {
      __syncthreads();   // every warp is done with rm and the ring
      if (threadIdx.x < 32) rm.build(qend_b, T, S, rep, r0);
      cur = rt;
    }
    __syncthreads();
    const int n = rm.n, k0 = r0 / rep;
    const SplitCut cut(rm.qmax, per_tile);
    if (sp >= cut.used) continue;
    const int sbeg = cut.first(sp) * kTileS;
    const int send = min(cut.first(sp + 1) * kTileS, rm.qmax);
    const int ntiles = cut.first(sp + 1) - cut.first(sp);

    // element offset of compacted row r's query (and output) row
    auto row_offset = [&](int r) {
      const int R = r0 + r;
      return (((size_t)b * T + rm.tok[R / rep - k0]) * H + hk * rep + R % rep) * DK;
    };
    // the lane's rows g and g + 8 of its warp: qend and the A fragments of
    // q (dk run [t4 * DK / 4, (t4 + 1) * DK / 4), 2 words a k step)
    int qe[2];
    uint32_t qa[G::KS][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      uint32_t w[2 * G::KS];
      if (r < n) {
        qe[h] = rm.qe[(r0 + r) / rep - k0];
        load_words(w, q + row_offset(r) + t4 * (DK / 4));
      } else {
        qe[h] = 0;
#pragma unroll
        for (int c = 0; c < 2 * G::KS; ++c) w[c] = 0;
      }
#pragma unroll
      for (int kstep = 0; kstep < G::KS; ++kstep) {
        qa[kstep][h] = w[2 * kstep];           // row g / g + 8, k 2t, 2t + 1
        qa[kstep][2 + h] = w[2 * kstep + 1];   // k 2t + 8, 2t + 9
      }
    }
    auto load_tile = [&](int buf, int s0) {
      unsigned char* kt = smem + buf * G::STAGE;
      unsigned char* vt = kt + kTileS * G::KSTR;
      float* kst = reinterpret_cast<float*>(vt + kTileS * G::VSTR);
      constexpr int CH = DK / 16;   // 16-byte pieces a row
      for (int i = threadIdx.x; i < kTileS * CH; i += 32 * W) {
        const int s = i / CH, c = (i % CH) * 16;
        const bool ok = s0 + s < send;
        const size_t off = (((size_t)b * S + s0 + s) * Hkv + hk) * DK + c;
        cp_async16(kt + s * G::KSTR + c, ok ? kq + off : kq, ok);
        cp_async16(vt + s * G::VSTR + c, ok ? vq + off : vq, ok);
      }
      for (int i = threadIdx.x; i < kTileS; i += 32 * W) {
        const bool ok = s0 + i < send;
        const size_t off = ((size_t)b * S + s0 + i) * Hkv + hk;
        cp_async4(kst + i, ok ? ks + off : ks, ok);
        cp_async4(kst + kTileS + i, ok ? vs + off : vs, ok);
      }
    };

    float o[G::ND][4];
#pragma unroll
    for (int nd = 0; nd < G::ND; ++nd)
      o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < ntiles) load_tile(i, sbeg + i * kTileS);
      cp_async_commit();
    }
    for (int it = 0; it < ntiles; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // tile it landed; every warp is done with tile it - 1
      {
        const int nx = it + kStages - 1;
        if (nx < ntiles) load_tile(nx % kStages, sbeg + nx * kTileS);
        cp_async_commit();
      }
      const unsigned char* kt = smem + (it % kStages) * G::STAGE;
      const unsigned char* vt = kt + kTileS * G::KSTR;
      const float* kst = reinterpret_cast<const float*>(vt + kTileS * G::VSTR);
      const float* vst = kst + kTileS;
      const int s0 = sbeg + it * kTileS;

      // scores of the tile's 64 slots: n8 tile j = slots 8j..8j+7
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
        uint32_t kw[G::KS];
        load_words(kw, kt + (8 * j + g) * G::KSTR + t4 * (DK / 4));
#pragma unroll
        for (int kstep = 0; kstep < G::KS; ++kstep)
          mma_bf16(sc[j], qa[kstep], k_pair(kw[kstep], 0), k_pair(kw[kstep], 1));
      }
      // lane holds rows g (h = 0: c0, c1) and g + 8 (h = 1: c2, c3) at slots
      // 8j + 2t4 + e; masked slots become -inf by selection
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = 8 * j + 2 * t4 + e;
          const float kscale = kst[slot] * qk_scale;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = s0 + slot < qe[h] ? sc[j][2 * h + e] * kscale
                                             : -INFINITY;
            sc[j][2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      float mref[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        mref[h] = m_new == -INFINITY ? 0.0f : m_new;   // a row with nothing seen yet
        const float corr = exp2_approx(m_run[h] - mref[h]);
        m_run[h] = m_new;
        l_run[h] *= corr;
#pragma unroll
        for (int nd = 0; nd < G::ND; ++nd) {
          o[nd][2 * h] *= corr;
          o[nd][2 * h + 1] *= corr;
        }
      }
      // weights: l sums p; P V takes p * v_scale (0 on a masked slot, whatever
      // its scale holds)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vscale = vst[8 * j + 2 * t4 + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = sc[j][2 * h + e];
            const bool vis = x != -INFINITY;
            const float p = vis ? exp2_approx(x - mref[h]) : 0.0f;
            l_run[h] += p;
            sc[j][2 * h + e] = vis ? p * vscale : 0.0f;
          }
        }
      // O += P V: k16 step kk = slots 16kk..16kk+15 (n8 tiles 2kk, 2kk + 1)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        pa[0] = f16x2(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = f16x2(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = f16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = f16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        // slots 16kk + 2t4 + {0, 1, 8, 9}; dk column g of n8 tile nd is
        // byte nd of the lane's DK/8-byte run at g * DK / 8
        const unsigned char* vr = vt + (16 * kk + 2 * t4) * G::VSTR + g * (DK / 8);
        uint32_t v0[DK / 32], v1[DK / 32], v8[DK / 32], v9[DK / 32];
        load_words(v0, vr);
        load_words(v1, vr + G::VSTR);
        load_words(v8, vr + 8 * G::VSTR);
        load_words(v9, vr + 9 * G::VSTR);
#pragma unroll
        for (int nd = 0; nd < G::ND; ++nd)
          mma_f16(o[nd], pa, v_pair(v0[nd / 4], v1[nd / 4], nd % 4),
                  v_pair(v8[nd / 4], v9[nd / 4], nd % 4));
      }
    }

    // the lane's run of a row: dk t4 * DK/4 + c, c < ND from o[c][2h] and
    // c >= ND from o[c - ND][2h + 1]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      const int r = 16 * warp + g + 8 * h;
      if (r >= n) continue;
      const float inv =
          per_tile > 1 ? 1.0f : l_run[h] > 0.0f ? 1.0f / l_run[h] : 0.0f;
      float v[2 * G::ND];
#pragma unroll
      for (int c = 0; c < G::ND; ++c) {
        v[c] = o[c][2 * h] * inv;
        v[G::ND + c] = o[c][2 * h + 1] * inv;
      }
      if (per_tile == 1) {
        uint4* dst = reinterpret_cast<uint4*>(out + row_offset(r) + t4 * (DK / 4));
#pragma unroll
        for (int c = 0; c < 2 * G::ND; c += 8)
          dst[c / 8] = make_uint4(bf16x2(v[c], v[c + 1]), bf16x2(v[c + 2], v[c + 3]),
                                  bf16x2(v[c + 4], v[c + 5]),
                                  bf16x2(v[c + 6], v[c + 7]));
      } else {   // unit u's slot of the workspace
        const size_t p = ((size_t)bh * splits + u) * RT + r;
        float4* dst = reinterpret_cast<float4*>(part_acc + p * DK + t4 * (DK / 4));
#pragma unroll
        for (int c = 0; c < 2 * G::ND; c += 4)
          dst[c / 4] = make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
        if (t4 == 0) {
          part_ml[2 * p] = m_run[h];
          part_ml[2 * p + 1] = l_run[h];
        }
      }
    }
  }
}

// The second pass, launched where tile_splits > 1, for the row tiles that
// took several splits (it returns at once where none did): warp w of a block
// merges compacted row R0 + w (rows dealt out 8 a block), its lane s < na
// holding split s's (m, l), where na is the number of splits that hold
// visible slots of the row; the lanes' float4 runs of the row add the
// splits' partials in split order, rescaled to their common maximum.
template <int DK, int W>
__global__ void __launch_bounds__(256)
prefill_merge_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ qend,
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv,
                     int S, int splits, int tile_splits) {
  constexpr int RT = 16 * W;
  __shared__ RowMap<RT> rm;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int rep = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* qend_b = qend + (size_t)b * T;
  if (threadIdx.x < 32) rm.build(qend_b, T, S, rep, 0);
  __syncthreads();
  const int rows = rm.valid * rep;
  const int per_tile = tile_splits_of(rows, RT, splits, tile_splits);
  if (per_tile == 1) return;   // every unit wrote its rows itself
  int cur = 0;
  for (int R0 = blockIdx.x * 8; R0 < rows; R0 += gridDim.x * 8) {
    const int rt = R0 / RT, R = R0 + warp, r = R - rt * RT;
    if (rt != cur) {
      __syncthreads();
      if (threadIdx.x < 32) rm.build(qend_b, T, S, rep, rt * RT);
      cur = rt;
    }
    __syncthreads();
    if (R >= rows) continue;
    const int ti = R / rep - rt * RT / rep;
    const int na = SplitCut(rm.qmax, per_tile).seen_by(rm.qe[ti]);
    const size_t u0 = (size_t)bh * splits + rt * per_tile;
    float m = -INFINITY, l = 0.0f;
    if (lane < na) {
      m = part_ml[2 * ((u0 + lane) * RT + r)];
      l = part_ml[2 * ((u0 + lane) * RT + r) + 1];
    }
    float mx = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float w = lane < na ? exp2_approx(m - mx) : 0.0f;
    float L = l * w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int s = 0; s < na; ++s) {   // unrolled: 4 loads in flight
      const float ws = __shfl_sync(0xffffffffu, w, s);
      if (lane < DK / 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            part_acc + ((u0 + s) * RT + r) * DK + 4 * lane);
        a.x = fmaf(v.x, ws, a.x);
        a.y = fmaf(v.y, ws, a.y);
        a.z = fmaf(v.z, ws, a.z);
        a.w = fmaf(v.w, ws, a.w);
      }
    }
    if (lane < DK / 4) {
      const float inv = L > 0.0f ? 1.0f / L : 0.0f;
      *reinterpret_cast<uint2*>(
          out + (((size_t)b * T + rm.tok[ti]) * H + hk * rep + R % rep) * DK +
          4 * lane) =
          make_uint2(bf16x2(a.x * inv, a.y * inv), bf16x2(a.z * inv, a.w * inv));
    }
  }
}

template <int DK, int W>
int launch_tc(const void* q, const void* kq, const void* ks, const void* vq,
              const void* vs, const void* qend, void* out, void* ws, int B,
              int T, int H, int Hkv, int S, int splits, int tile_splits,
              cudaStream_t stream) {
  auto kernel = prefill_tc_kernel<DK, W>;
  static bool configured = false;  // idempotent, so a race is harmless
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcGeo<DK>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  float* part_acc = static_cast<float*>(ws);
  float* part_ml = part_acc + (size_t)B * Hkv * splits * 16 * W * DK;
  const float qk_scale = 1.4426950408889634f / sqrtf(static_cast<float>(DK));
  kernel<<<dim3(splits, B * Hkv), 32 * W, TcGeo<DK>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(qend),
      static_cast<__nv_bfloat16*>(out), part_acc, part_ml, T, H, Hkv, S,
      tile_splits, qk_scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tile_splits == 1) return static_cast<int>(e);
  prefill_merge_kernel<DK, W><<<dim3(2 * W, B * Hkv), 256, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(qend),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, splits, tile_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch_tc_w(int warps, const void* q, const void* kq, const void* ks,
                const void* vq, const void* vs, const void* qend, void* out,
                void* ws, int B, int T, int H, int Hkv, int S, int splits,
                int tile_splits, cudaStream_t s) {
  if (warps == 1)
    return launch_tc<DK, 1>(q, kq, ks, vq, vs, qend, out, ws, B, T, H, Hkv, S,
                            splits, tile_splits, s);
  if (warps == 2)
    return launch_tc<DK, 2>(q, kq, ks, vq, vs, qend, out, ws, B, T, H, Hkv, S,
                            splits, tile_splits, s);
  if (warps == 4)
    return launch_tc<DK, 4>(q, kq, ks, vq, vs, qend, out, ws, B, T, H, Hkv, S,
                            splits, tile_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel), for q and out. dk: 64 or 128. warps (1, 2 or 4: row tiles of
// 16 * warps), splits (blocks a (b, kv head), at most 32) and tile_splits
// (the most splits a row tile takes, 1..splits) come from
// ops/attention.prefill_plan; ws holds B * Hkv * splits * 16 * warps *
// (dk + 2) floats when tile_splits > 1 (else unused, may be null). bf16
// needs q, k_q, v_q and out 16-byte aligned.
// Returns the cudaError_t of the launches (0 = success). Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int prefill_quant_launch(int dtype, const void* q, const void* kq,
                                    const void* ks, const void* vq,
                                    const void* vs, const void* qend,
                                    void* out, void* ws, int B, int T_len,
                                    int H, int Hkv, int S, int dk, int warps,
                                    int splits, int tile_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || splits < 1 || splits > kMaxSplits ||
      tile_splits < 1 || tile_splits > splits ||
      (tile_splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && dk == 128)
    launch_simt<float, 128>(q, kq, ks, vq, vs, qend, out, B, T_len, H, Hkv, S, s);
  else if (dtype == 0 && dk == 64)
    launch_simt<float, 64>(q, kq, ks, vq, vs, qend, out, B, T_len, H, Hkv, S, s);
  else if (dtype == 1 && dk == 128)
    return launch_tc_w<128>(warps, q, kq, ks, vq, vs, qend, out, ws, B, T_len,
                            H, Hkv, S, splits, tile_splits, s);
  else if (dtype == 1 && dk == 64)
    return launch_tc_w<64>(warps, q, kq, ks, vq, vs, qend, out, ws, B, T_len,
                           H, Hkv, S, splits, tile_splits, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
