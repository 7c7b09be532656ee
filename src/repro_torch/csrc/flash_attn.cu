// Flash-attention forward (K3): grouped-query attention with an online
// softmax, for prefill.
//
// Replaces the Pallas kernel src/repro/kernels/flash.py:70
// (flash_attention, body _flash_kernel).  It computes the same function:
// q is scaled in float32, logits are float32, an optional tanh softcap
// c*tanh(x/c) follows, the causal mask keeps key t for query s when t <= s
// (both counted from 0), the softmax runs online over key tiles with a
// running max m, sum l and a float32 accumulator, rows with l == 0 divide by
// 1, and the output is cast to the input type.  The causal mask takes the
// two refinements of the reference's model path (_mask_block,
// src/repro/models/attention.py): a local window W keeps only keys
// t > s - W (gemma2), and a bidirectional prefix P lets every query s < P
// see every key t < P (paligemma); see causal_visible.  Each block loops
// over the key tiles that some row of it can see (key_range), so a
// windowed block starts at its window's first tile.  Given a pointer, every
// kernel also writes each row's log-sum-exp m + log l (natural-log units;
// 0 for a row that sees no key), which the backward (flash_attn_bwd.cu)
// reads instead of recomputing the logits; serving passes none.
//
// What differs from the TPU version:
// - GQA: query head h reads K/V of KV head h / (H / KVH) in place; the
//   Pallas wrapper materialises repeat(k, G) in device memory instead.
// - Any S and T: the ragged last query block and key tile are masked here,
//   where the Pallas version asserts S % bq == 0 and T % bk == 0.
// - Blocks run in parallel in no order, so each block owns one (batch,
//   query head, query block) and loops over key tiles itself; the causal
//   loop stops at the block's last row (or the prefix's end), starts at the
//   window of its first row, and the heaviest causal blocks are scheduled
//   first.
//
// Bound on the H100: operations.  At prefill shapes (S = 2048, hd = 128)
// the two products do ~S/2 multiply-adds per byte of q, k, v and out, far
// above the card's ratio of flops to bytes (~295 bf16 flops per byte), so
// the kernel's business is to keep the tensor cores fed and the logits out
// of device memory.  Which kernel takes which (dtype, hd):
// - bfloat16, hd in {64, 80, 128, 256} (the serving path: every
//   dense-global config has hd 128, zamba2's shared attention block hd 80):
//   the Hopper kernel (namespace hopper).  128 query rows per block in two
//   consumer warpgroups of 64 rows and one producer warpgroup (384
//   threads, setmaxnreg 24 / 240); Q loaded once and K/V through a 2-stage
//   ring of 128-key tiles (64 at hd 256) by TMA with 128-byte swizzle (hd
//   80: a 64-column chunk with it and a 16-column chunk with the 32-byte
//   swizzle), each stage guarded by full/empty mbarriers; both
//   products on wgmma (S = Q K^T from shared memory, O += P V with P in
//   registers), the softmax of one tile overlapping the P V product of the
//   previous, and the two consumer warpgroups taking turns at the tensor
//   cores.  p is rounded to bfloat16 for P V (the row sum l keeps the
//   float32 values), as FlashAttention-3 and the reference's dense path do.
// - bfloat16, hd in {16, 32} (the smoke configs): mma.sync tensor-core
//   products, four warps per 64-row query block, synchronous K/V tile loads
//   (namespace tc); p.v in TF32.  No full-size model has these widths.
// - float32 (whose 1e-5 tolerance rules out TF32), and hd = 8: the products
//   on the float32 FMA pipes (67 TFLOP/s): a 64 x 64 logits tile per block
//   of 128 threads, each thread holding an 8 x 4 block of logits and an
//   8 x hd/16 block of the output in registers; Q (scaled, float32), K and V
//   staged in shared memory with rows padded so the column-parallel reads
//   hit distinct banks.  The 16 threads that share a row group form a
//   half-warp, so row max and row sum are warp shuffles and P passes
//   through shared memory without a block barrier.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace flash {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // threads per block: 8 row groups x 16 columns
constexpr int RPT = BQ / 8;   // query rows per thread
constexpr int SC = BK / 16;   // logit columns per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout: Qs (BQ x QLD float), Ps (BQ x PLD float), Ks
// (BK x KLD T), Vs (BK x HD T).  The row pads make every row stride an odd
// number of 32-bit words, so 16 threads reading one column of 16 rows hit
// 16 banks.
template <typename T, int HD>
struct Smem {
  static constexpr int QLD = HD + 1;
  static constexpr int PLD = BK + 1;
  static constexpr int KLD = HD + 4 / static_cast<int>(sizeof(T));
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QLD + BQ * PLD) + sizeof(T) * (BK * KLD + BK * HD);
};

// Key t visible to query s (both counted from 0) under the causal mask with
// a window (0: none) and a bidirectional prefix (0: none):
//   (t <= s and (window == 0 or t > s - window)) or (t < prefix and s < prefix)
__device__ __forceinline__ bool causal_visible(int t, int s, int window, int prefix) {
  return (t <= s && (window == 0 || t > s - window)) || (t < prefix && s < prefix);
}

// The keys [begin, end) that some query row in [q0, q1) sees under that
// mask, with Tk keys (q0 < q1, Tk >= 1).  begin < end: where no row sees a
// key (T shorter than the window's start), the range is the last key alone,
// which the mask hides from every row.
struct KeyRange {
  int begin, end;
};
__device__ __forceinline__ KeyRange key_range(int q0, int q1, int Tk, int window, int prefix) {
  int end = min(Tk, q1);
  int begin = window ? max(0, q0 - window + 1) : 0;
  if (q0 < prefix) {            // a row of the prefix sees keys 0 .. prefix - 1
    end = max(end, min(prefix, Tk));
    begin = 0;
  }
  return {min(begin, end - 1), end};
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A row's log-sum-exp of its logits in natural-log units, from its running
// max m and sum l (m in natural-log units), for the backward; 0 for a row
// that sees no key (l == 0), which the backward never reads.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : 0.f;
}

// q, out: (B, S, H, HD); k, v: (B, Tk, KVH, HD); all contiguous.
// grid: (ceil(S / BQ), H, B).
template <typename T, int HD, bool CAUSAL, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int KVH, float scale, float cap, int window, int prefix,
                 float* __restrict__ lse) {
  using L = Smem<T, HD>;
  constexpr int OC = HD >= 16 ? HD / 16 : 1;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ps = Qs + BQ * L::QLD;
  T* Ks = reinterpret_cast<T*>(Ps + BQ * L::PLD);
  T* Vs = Ks + BK * L::KLD;

  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int row0 = (tid >> 4) * RPT;           // this thread's first row
  const int cg = tid & 15;                     // this thread's column group
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KVH) * HD;
  const T* q_base = q + (static_cast<long long>(b) * S * H + h) * HD;
  const T* k_base = k + (static_cast<long long>(b) * Tk * KVH + kvh) * HD;
  const T* v_base = v + (static_cast<long long>(b) * Tk * KVH + kvh) * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * L::QLD + d] = s < S ? to_float(q_base[s * q_stride + d]) * scale : 0.f;
  }

  float acc[RPT][OC];
  float m_run[RPT], l_run[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int o = 0; o < OC; ++o) acc[i][o] = 0.f;
  }

  // keys any row of this block can see
  const KeyRange kr = CAUSAL ? key_range(q0, min(q0 + BQ, S), Tk, window, prefix)
                             : KeyRange{0, Tk};
  for (int k0 = kr.begin / BK * BK; k0 < kr.end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      const bool in = t < Tk;
      Ks[r * L::KLD + d] = in ? k_base[t * kv_stride + d] : from_float<T>(0.f);
      Vs[r * HD + d] = in ? v_base[t * kv_stride + d] : from_float<T>(0.f);
    }
    __syncthreads();

    float logit[RPT][SC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < SC; ++c) logit[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kk[SC];
#pragma unroll
      for (int c = 0; c < SC; ++c) kk[c] = to_float(Ks[(cg + 16 * c) * L::KLD + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qq = Qs[(row0 + i) * L::QLD + d];
#pragma unroll
        for (int c = 0; c < SC; ++c) logit[i][c] = fmaf(qq, kk[c], logit[i][c]);
      }
    }

    // softcap, mask, online softmax; P goes to this half-warp's rows of Ps
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int q_pos = q0 + row0 + i;
      float m_tile = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int k_pos = k0 + cg + 16 * c;
        float x = logit[i][c];
        if constexpr (SOFTCAP) x = cap * tanhf(x / cap);
        const bool visible =
            k_pos < Tk && (!CAUSAL || causal_visible(k_pos, q_pos, window, prefix));
        logit[i][c] = visible ? x : -CUDART_INF_F;
        m_tile = fmaxf(m_tile, logit[i][c]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(m_tile));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;   // nothing visible yet
      const float alpha = expf(m_run[i] - m_use);
      float l_tile = 0.f;
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const float p = expf(logit[i][c] - m_use);
        Ps[(row0 + i) * L::PLD + cg + 16 * c] = p;
        l_tile += p;
      }
      l_run[i] = l_run[i] * alpha + half_warp_sum(l_tile);
      m_run[i] = m_new;
#pragma unroll
      for (int o = 0; o < OC; ++o) acc[i][o] *= alpha;
    }
    __syncwarp();      // a half-warp reads back only the rows it wrote

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[OC];
#pragma unroll
      for (int o = 0; o < OC; ++o) {
        const int col = cg + 16 * o;
        vv[o] = (HD >= 16 || col < HD) ? to_float(Vs[j * HD + col]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(row0 + i) * L::PLD + j];
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[i][o] = fmaf(p, vv[o], acc[i][o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + row0 + i;
    if (s >= S) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    T* o_row = out + ((static_cast<long long>(b) * S + s) * H + h) * HD;
#pragma unroll
    for (int o = 0; o < OC; ++o) {
      const int col = cg + 16 * o;
      if (HD >= 16 || col < HD) o_row[col] = from_float<T>(acc[i][o] / l);
    }
    if (lse != nullptr && cg == 0)
      lse[(static_cast<long long>(b) * H + h) * S + s] = row_lse(m_run[i], l_run[i]);
  }
}

// --------------------------------------------------------------------------
// bfloat16, hd in {16, 32}: the two products on the tensor cores
// (mma.sync).
//
// Four warps per 64-row query block, 16 rows each.  Rows of Q, K and V sit
// in shared memory at a stride of HD + 8 bf16 (16 bytes of pad: an odd
// number of 16-byte units a row, so the 8 row groups of a fragment load
// fall in distinct banks).  Logits: m16n8k16 bf16
// products of Q and K (exact products, float32 sums), then scaled in
// float32.  Softmax in float32 on the accumulator fragments.  P @ V:
// m16n8k8 TF32 products, so p keeps 10 mantissa bits (bf16 would keep 7);
// the bf16 values of V are exact in TF32.  A thread's logits for keys 2t
// and 2t+1 of an 8-key group are the A fragment of m16n8k8 once the
// group's keys are taken in the order (0, 2, 4, 6, 1, 3, 5, 7): V's B
// fragment reads its rows in that order too, so no shuffles are needed.
// --------------------------------------------------------------------------
namespace tc {

template <int HD>
struct Cfg {
  static constexpr int BK = 64;                    // keys per tile
  static constexpr int LD = HD + 8;                // row stride (bf16): 16 B pad
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (BQ + 2 * BK) * LD;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ROWS rows of HD bf16 from src (row r at src + (row0 + r) * stride) into
// dst (row stride LD), 16 bytes per load; rows >= n_rows are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int n_rows) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Cfg<HD>::LD + c * 8) = val;
  }
}

template <int HD, bool CAUSAL, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int S, int Tk, int H, int KVH,
                     float scale, float cap, int window, int prefix, float* __restrict__ lse) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, LD = C::LD, NS = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qb * BQ;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;      // this warp's first row
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KVH) * HD;
  const __nv_bfloat16* k_base = k + (static_cast<long long>(b) * Tk * KVH + kvh) * HD;
  const __nv_bfloat16* v_base = v + (static_cast<long long>(b) * Tk * KVH + kvh) * HD;

  load_tile<HD, BQ>(Qs, q + (static_cast<long long>(b) * S * H + h) * HD, q_stride, q0, S);

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  const KeyRange kr = CAUSAL ? key_range(q0, min(q0 + BQ, S), Tk, window, prefix)
                             : KeyRange{0, Tk};
  for (int k0 = kr.begin / BK * BK; k0 < kr.end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    load_tile<HD, BK>(Ks, k_base, kv_stride, k0, Tk);
    load_tile<HD, BK>(Vs, v_base, kv_stride, k0, Tk);
    __syncthreads();

    // s[n][e]: rows wr + g (e < 2) and wr + g + 8, key k0 + 8n + 2t + (e & 1)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (wr + g) * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], a, ld32(kb), ld32(kb + 8));
      }
    }

    float m_tile[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = q0 + wr + g + (e >> 1) * 8;
        const int k_pos = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if constexpr (SOFTCAP) x = cap * tanhf(x / cap);
        const bool visible =
            k_pos < Tk && (!CAUSAL || causal_visible(k_pos, q_pos, window, prefix));
        s[n][e] = visible ? x : -CUDART_INF_F;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[n][e]);
      }
    float m_use[2], alpha[2], l_tile[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[r], mt);
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;   // nothing visible yet
      alpha[r] = expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_use[e >> 1]);
        l_tile[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l_tile[r] + __shfl_xor_sync(0xffffffffu, l_tile[r], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      l_run[r] = l_run[r] * alpha[r] + lt;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const uint32_t a[4] = {to_tf32(s[n][0]), to_tf32(s[n][2]), to_tf32(s[n][1]),
                             to_tf32(s[n][3])};
      const __nv_bfloat16* vb = Vs + (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        mma_tf32(o[d], a, __float_as_uint(__bfloat162float(vb[d * 8])),
                 __float_as_uint(__bfloat162float(vb[LD + d * 8])));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = q0 + wr + g + r * 8;
    if (s_row >= S) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* o_row = out + ((static_cast<long long>(b) * S + s_row) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(o_row + d * 8 + 2 * t) =
          __floats2bfloat162_rn(o[d][2 * r] / l, o[d][2 * r + 1] / l);
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * H + h) * S + s_row] = row_lse(m_run[r], l_run[r]);
  }
}

}  // namespace tc

// --------------------------------------------------------------------------
// bfloat16, hd in {64, 80, 128, 256}: the Hopper kernel (TMA, mbarriers,
// wgmma, warp specialisation).
//
// Block: 128 query rows of one (batch, query head), 384 threads in three
// warpgroups.  Warpgroup 0 is the producer: it gives up registers
// (setmaxnreg 24) and one of its threads issues every TMA load.
// Warpgroups 1 and 2 are the consumers, 64 query rows each (setmaxnreg
// 240).
//
// Shared memory: Q (128 rows, loaded once) and a ring of STAGES = 2 K
// tiles and 2 V tiles of BK keys.  Every tile is stored as hd / 64 column
// chunks of 64 bf16 (128 bytes) per row, the layout of TMA's 128-byte
// swizzle, which is also the layout wgmma reads (see smem_desc).  At hd
// 80 (160-byte rows) a tile is one such chunk (columns 0-63) and a tail
// chunk of 16 columns (64-79) at 32 bytes a row with the 32-byte swizzle:
// both are layouts that TMA writes and wgmma reads, so nothing is padded,
// S = Q K^T takes a fifth k-step over the tail, and O += P V adds an
// m64n16 product over the tail to the m64n64 one (together the register
// order of one m64n80 accumulator).  Each
// stage has a "full" barrier (the producer's arrive.expect_tx, completed
// by the TMA's bytes) and an "empty" barrier (one arrival from each of the
// 8 consumer warps once the wgmma that read the tile has finished), for K
// and V apart: K is free as soon as S = Q K^T is done, V only after
// O += P V, so the producer loads K one tile ahead of V.
//
// A consumer warpgroup runs, for key tile j:
//   S_j = Q K_j^T            wgmma m64nBKk16, both operands in shared memory
//   O += P_{j-1} V_{j-1}     wgmma m64nHDk16, P in registers, V MN-major
//   softmax of S_j (while the second product runs), then O *= alpha_j and
//   P_j = bf16(exp2(S_j - m_j)) in registers, the A fragments of the next
//   product (the accumulator of one product is the register A operand of
//   the next with no shuffle).
// The two consumer warpgroups take turns issuing their two products
// (named barriers 1 and 2), so one's softmax runs while the tensor cores
// work on the other's products.  Row max and row sum are reduced over the
// 4 threads that hold a row; l sums the float32 probabilities and p is
// rounded to bfloat16 for P V, as the reference's dense path does.  The
// block runs the key tiles j0 .. n_tiles - 1 that some row of it sees
// (key_range: from its first row's window, to its last row's diagonal or
// the prefix's end); the ring's stages and parities count from j0, in the
// producer and both consumers alike.  A tile whose every key every row of
// the warpgroup sees skips the mask (tile_unmasked); the others, at the
// diagonal, at the window's lower edge, at the prefix's corner and the
// ragged last tile, take it, and a row that sees nothing of a tile keeps
// its m, l and O (the m == -inf guard of softmax_tile).  Registers: 168
// per thread at launch; ptxas fits the consumers in 240 with no spill at
// hd 64, 80, 128 and 256.
// --------------------------------------------------------------------------
namespace hopper {

using namespace sm90;   // TMA, descriptors, wgmma products (hopper.cuh)

constexpr int BQ = 128;          // query rows per block
constexpr int NT = 384;          // threads per block
constexpr int STAGES = 2;        // K/V ring depth

template <int HD>
struct Cfg {
  static constexpr int BK = HD >= 256 ? 64 : 128;              // keys per tile
  static constexpr int NCH = HD / CW;                          // 128-byte chunks
  static constexpr bool TAIL = HD % CW != 0;                   // a 16-column chunk
  static_assert(HD % CW == 0 || HD % CW == TW, "hd: 64-column chunks and one 16-column tail");
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;                 // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // Q, K ring, V ring, 1 + 4 * STAGES barriers, 1 KB to align the base
  static constexpr size_t bytes = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

// Named barriers 1 and 2 (0 is __syncthreads), 256 threads: the two
// consumer warpgroups take turns issuing their wgmmas.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Whether every key of the tile [k0, k0 + BK) is visible to every row of
// [r0, r0 + 64) (rows past S included, which only masks more than needed):
// the tile lies in T and below the diagonal and above the window of every
// row, or in the prefix's square.
template <int BK, bool CAUSAL>
__device__ __forceinline__ bool tile_unmasked(int k0, int r0, int Tk, int window, int prefix) {
  if (k0 + BK > Tk) return false;
  if (!CAUSAL) return true;
  const int r1 = r0 + 63;
  return (k0 + BK - 1 <= r0 && (window == 0 || k0 > r1 - window)) ||
         (k0 + BK <= prefix && r1 < prefix);
}

// Online softmax of one tile in place: the raw sums s become
// p = exp2(x - m), x the scaled (and capped) logit in log2 units, masked to
// -inf where the key is past T or (causal) hidden from the row
// (causal_visible, as bounds per row: three compares per logit of a masked
// tile, one more than the causal mask alone); m and l (this thread's part of
// the row sum) move on, alpha is the rescale of earlier terms.  Row r of the thread
// is row[r]; column of s[i] is k0 + 8 (i / 4) + 2t + i % 2.
template <int NS, bool MASK, bool CAUSAL, bool SOFTCAP>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const int (&row)[2],
                                             int t, int Tk, int window, int prefix,
                                             float scale_log2, float scale, float cap) {
  float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
  // row r sees the keys in (lo, hi] and those below pe
  int hi[2], lo[2], pe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = CAUSAL ? min(row[r], Tk - 1) : Tk - 1;
    lo[r] = CAUSAL && window ? row[r] - window : -1;
    pe[r] = CAUSAL && row[r] < prefix ? min(prefix, Tk) : 0;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    float x;
    if constexpr (SOFTCAP)
      x = cap * tanhf(s[i] * scale / cap) * LOG2E;
    else
      x = s[i] * scale_log2;
    if constexpr (MASK) {
      const int k_pos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!((k_pos <= hi[r] && k_pos > lo[r]) || k_pos < pe[r])) x = -CUDART_INF_F;
    }
    s[i] = x;
    mt[r] = fmaxf(mt[r], x);
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;   // nothing visible yet
    alpha[r] = ex2(m[r] - m_use[r]);
    m[r] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(s[i] - m_use[r]);
    ls[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

template <int NS, bool CAUSAL, bool SOFTCAP>
__device__ __forceinline__ void softmax_any(bool mask, float (&s)[NS], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2], int k0,
                                            const int (&row)[2], int t, int Tk, int window,
                                            int prefix, float scale_log2, float scale,
                                            float cap) {
  if (mask)
    softmax_tile<NS, true, CAUSAL, SOFTCAP>(s, m, l, alpha, k0, row, t, Tk, window, prefix,
                                            scale_log2, scale, cap);
  else
    softmax_tile<NS, false, CAUSAL, SOFTCAP>(s, m, l, alpha, k0, row, t, Tk, window, prefix,
                                             scale_log2, scale, cap);
}


// q, out: (B, S, H, HD); k, v: (B, Tk, KVH, HD); bf16, described by the
// tensor maps (see encode): tm_q, tm_k and tm_v for the 64-column chunks,
// tm_q_tail, tm_k_tail and tm_v_tail for hd 80's 16-column tail chunk
// (unused at the other widths; last, so that the other parameters keep
// their places).  1-D grid of ceil(S / BQ) * H * B blocks, the last query
// blocks (the heaviest under the causal mask) first.
template <int HD, bool CAUSAL, bool SOFTCAP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out, int S, int Tk, int H, int KVH,
                       int B, float scale, float cap, int window, int prefix,
                       const __grid_constant__ CUtensorMap tm_q_tail,
                       const __grid_constant__ CUtensorMap tm_k_tail,
                       const __grid_constant__ CUtensorMap tm_v_tail,
                       float* __restrict__ lse) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, NCH = C::NCH;
  extern __shared__ unsigned char smem_raw[];
  // every chunk starts on 1 KB (a 128-byte swizzle atom; the 32-byte
  // swizzle's is 256 B): Q, K and V tiles are multiples of 1 KB
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + C::Q_BYTES;                         // + stage * KV_BYTES
  const uint32_t v_s = k_s + STAGES * C::KV_BYTES;
  const uint32_t bars = q_s + C::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * STAGES + st); };

  const int nqb = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % (H * B);
  const int qb = nqb - 1 - blockIdx.x / (H * B);
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  const int q0 = qb * BQ;
  // the key tiles j0 .. n_tiles - 1 hold every key some row sees; the ring
  // runs n = n_tiles - j0 >= 1 of them, stage i % STAGES for tile j0 + i
  const KeyRange kr = CAUSAL ? key_range(q0, min(q0 + BQ, S), Tk, window, prefix)
                             : KeyRange{0, Tk};
  const int j0 = kr.begin / BK;
  const int n = (kr.end + BK - 1) / BK - j0;
  // the warpgroup's role, through a shuffle so the compiler sees it is
  // uniform across each warp (wgmma needs converged warps)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);     // one arrival per consumer warp
      mbar_init(v_empty(st), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < NCH; ++c) tma_load(&tm_q, q_full, q_s + c * BQ * 128, c * CW, h, q0, b);
      if constexpr (C::TAIL) tma_load(&tm_q_tail, q_full, q_s + NCH * BQ * 128, NCH * CW, h, q0, b);
      // ring position i holds key tile j0 + i
      auto load_k = [&](int i) {
        const int st = i % STAGES;
        mbar_wait(k_empty(st), ((i / STAGES) & 1) ^ 1);   // passes on the first round
        mbar_expect_tx(k_full(st), C::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(&tm_k, k_full(st), k_s + st * C::KV_BYTES + c * BK * 128, c * CW, kvh,
                   (j0 + i) * BK, b);
        if constexpr (C::TAIL)
          tma_load(&tm_k_tail, k_full(st), k_s + st * C::KV_BYTES + NCH * BK * 128, NCH * CW,
                   kvh, (j0 + i) * BK, b);
      };
      auto load_v = [&](int i) {
        const int st = i % STAGES;
        mbar_wait(v_empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(v_full(st), C::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(&tm_v, v_full(st), v_s + st * C::KV_BYTES + c * BK * 128, c * CW, kvh,
                   (j0 + i) * BK, b);
        if constexpr (C::TAIL)
          tma_load(&tm_v_tail, v_full(st), v_s + st * C::KV_BYTES + NCH * BK * 128, NCH * CW,
                   kvh, (j0 + i) * BK, b);
      };
      // K runs one tile ahead of V: S_{i+1} needs K_{i+1} before P_i V_i
      // needs V_i, and a V slot frees only after the P V product that read it
      load_k(0);
      for (int i = 0; i < n; ++i) {
        if (i + 1 < n) load_k(i + 1);
        load_v(i);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
    const int t = lane & 3;
    const int row0 = q0 + 64 * (wg - 1);                      // this warpgroup's first row
    const int row[2] = {row0 + 16 * warp + (lane >> 2), row0 + 16 * warp + (lane >> 2) + 8};
    // both warpgroups run every tile of the block (a tile that none of a
    // warpgroup's rows sees leaves its m, l and O as they were), so their
    // turns at the tensor cores alternate one for one
    if (wg == 2) named_arrive(1);             // warpgroup 1 issues first
    // whether ring position i's tile needs the mask for this warpgroup
    auto masked = [&](int i) {
      return !tile_unmasked<BK, CAUSAL>((j0 + i) * BK, row0, Tk, window, prefix);
    };
    const float scale_log2 = scale * LOG2E;
    const uint32_t q_rows = q_s + (wg - 1) * 64 * 128;
    const uint32_t q_tail = q_s + NCH * BQ * 128 + (wg - 1) * 64 * TW * 2;   // hd 80
    auto release = [&](uint32_t bar) { mbar_arrive_if(bar, lane == 0); };

    float o[HD / 2], s[BK / 2], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float alpha[2];
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

    // n >= 1: S >= 1 and T >= 1 (T = 0 never launches)
    mbar_wait(q_full, 0);
    {
      mbar_wait(k_full(0), 0);
      named_sync(wg);
      wgmma_fence();
      issue_ss<HD, BQ, BK>(s, q_rows, q_tail, k_s);
      wgmma_commit();
      named_arrive(3 - wg);
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty(0));
      softmax_any<BK / 2, CAUSAL, SOFTCAP>(masked(0), s, m, l, alpha, j0 * BK, row, t, Tk,
                                           window, prefix, scale_log2, scale, cap);
      to_bf16(s, p);
    }
    for (int i = 1; i < n; ++i) {
      const int st = i % STAGES, prev = (i - 1) % STAGES;
      mbar_wait(k_full(st), (i / STAGES) & 1);
      mbar_wait(v_full(prev), ((i - 1) / STAGES) & 1);
      named_sync(wg);
      wgmma_fence();                      // p and o were written by ordinary code
      issue_ss<HD, BQ, BK>(s, q_rows, q_tail, k_s + st * C::KV_BYTES);
      wgmma_commit();
      issue_rs<HD, BK>(o, p, v_s + prev * C::KV_BYTES);
      wgmma_commit();
      named_arrive(3 - wg);
      wgmma_wait<1>();                    // S_j is done; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      release(k_empty(st));
      softmax_any<BK / 2, CAUSAL, SOFTCAP>(masked(i), s, m, l, alpha, (j0 + i) * BK, row, t,
                                           Tk, window, prefix, scale_log2, scale, cap);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(v_empty(prev));
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_bf16(s, p);
    }
    {
      const int i = n - 1, st = i % STAGES;
      mbar_wait(v_full(st), (i / STAGES) & 1);
      named_sync(wg);
      wgmma_fence();
      issue_rs<HD, BK>(o, p, v_s + st * C::KV_BYTES);
      wgmma_commit();
      if (wg == 1) named_arrive(2);       // warpgroup 2 issues last
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty(st));
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.f / (lr == 0.f ? 1.f : lr);
      // the row's lse for the backward: m is in log2 units
      if (lse != nullptr && t == 0 && row[r] < S)
        lse[(static_cast<long long>(b) * H + h) * S + row[r]] =
            lr == 0.f ? 0.f : m[r] * LN2 + logf(lr);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= S) continue;
      __nv_bfloat16* o_row = out + ((static_cast<long long>(b) * S + row[r]) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// ---- host side: the launch

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
           int KVH, float scale, bool causal, bool softcap, float cap, int window, int prefix,
           float* lse, cudaStream_t stream) {
  if (Tk == 0) {  // no keys: every row has l == 0 and gives zeros (and lse 0)
    if (lse != nullptr) {
      const cudaError_t err = cudaMemsetAsync(lse, 0, sizeof(float) * B * H * S, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(
        cudaMemsetAsync(out, 0, sizeof(__nv_bfloat16) * B * S * H * HD, stream));
  }
  constexpr int BK = Cfg<HD>::BK;
  constexpr auto SW = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, HD, H, S, B, BQ, CW, SW) || !encode(&tk, k, HD, KVH, Tk, B, BK, CW, SW) ||
      !encode(&tv, v, HD, KVH, Tk, B, BK, CW, SW))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq_tail = tq, tk_tail = tk, tv_tail = tv;   // the tail's maps, hd 80 only
  if constexpr (Cfg<HD>::TAIL) {
    constexpr auto SWT = CU_TENSOR_MAP_SWIZZLE_32B;
    if (!encode(&tq_tail, q, HD, H, S, B, BQ, TW, SWT) ||
        !encode(&tk_tail, k, HD, KVH, Tk, B, BK, TW, SWT) ||
        !encode(&tv_tail, v, HD, KVH, Tk, B, BK, TW, SWT))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_flag(causal, [&](auto CAUSAL) {
    return with_flag(softcap, [&](auto SOFTCAP) {
      auto kernel =
          flash_fwd_wgmma_kernel<HD, decltype(CAUSAL)::value, decltype(SOFTCAP)::value>;
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Cfg<HD>::bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = (S + BQ - 1) / BQ * H * B;
      kernel<<<blocks, NT, Cfg<HD>::bytes, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, Tk, H, KVH, B, scale, cap, window,
          prefix, tq_tail, tk_tail, tv_tail, lse);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace hopper

template <typename T, typename Kernel>
int run(Kernel kernel, size_t smem, const void* q, const void* k, const void* v,
        void* out, int B, int S, int Tk, int H, int KVH, float scale, float cap,
        int window, int prefix, float* lse, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(out), S,
                                     Tk, H, KVH, scale, cap, window, prefix, lse);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 with hd 64, 80, 128 or 256 takes the Hopper kernel, with hd 16
// or 32 the mma.sync kernel; float32 (whose tolerance TF32 would not meet)
// and hd = 8 the FMA kernel.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int Tk, int H, int KVH, float scale, bool causal, bool softcap,
           float cap, int window, int prefix, float* lse, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> &&
                (HD == 64 || HD == 80 || HD == 128 || HD == 256))
    return hopper::launch<HD>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                              window, prefix, lse, stream);
  else
    return with_flag(causal, [&](auto CAUSAL) {
      return with_flag(softcap, [&](auto SOFTCAP) {
        constexpr bool kCausal = decltype(CAUSAL)::value;
        constexpr bool kSoftcap = decltype(SOFTCAP)::value;
        if constexpr (std::is_same_v<T, __nv_bfloat16> && HD >= 16)
          return run<T>(tc::flash_fwd_mma_kernel<HD, kCausal, kSoftcap>, tc::Cfg<HD>::bytes,
                        q, k, v, out, B, S, Tk, H, KVH, scale, cap, window, prefix, lse,
                        stream);
        else
          return run<T>(flash_fwd_kernel<T, HD, kCausal, kSoftcap>, Smem<T, HD>::bytes, q,
                        k, v, out, B, S, Tk, H, KVH, scale, cap, window, prefix, lse,
                        stream);
      });
    });
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out, int B,
             int S, int Tk, int H, int KVH, float scale, bool causal, bool softcap,
             float cap, int window, int prefix, float* lse, cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                          window, prefix, lse, stream);
    case 16:
      return launch<T, 16>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                           window, prefix, lse, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                           window, prefix, lse, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                           window, prefix, lse, stream);
    case 80:
      return launch<T, 80>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                           window, prefix, lse, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                            window, prefix, lse, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap,
                            window, prefix, lse, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
}  // namespace repro

// q, out: (B, S, H, hd); k, v: (B, T, KVH, hd); contiguous, one dtype
// (0 = float32, 2 = bfloat16); H a multiple of KVH; hd in {8, 16, 32, 64,
// 80, 128, 256}.  softcap <= 0 means none.  With causal != 0, window > 0 keeps
// only keys t > s - window and prefix > 0 opens the prefix's square
// (causal_visible); window 0 and prefix 0 mean none, and both are ignored
// when causal is 0.  lse: null, or a float32 (B, H, S) that receives each
// row's log-sum-exp of its (scaled, capped, visible) logits in natural-log
// units, the backward's row statistics (0 for a row that sees no key).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int S, int T, int H, int KVH,
                                     int hd, int dtype, double scale, double softcap,
                                     int causal, int window, int prefix, void* lse,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T < 0 || window < 0 || prefix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (causal == 0) window = prefix = 0;
  auto s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  auto* l = static_cast<float*>(lse);
  if (dtype == 0)
    return repro::flash::dispatch<float>(hd, q, k, v, out, B, S, T, H, KVH, sc,
                                         causal != 0, softcap > 0, cap, window, prefix, l, s);
  if (dtype == 2)
    return repro::flash::dispatch<__nv_bfloat16>(hd, q, k, v, out, B, S, T, H, KVH, sc,
                                                 causal != 0, softcap > 0, cap, window,
                                                 prefix, l, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The version of repro_flash_attention's arguments, for tools that call
// libraries built from other commits: 1 since it takes the lse pointer; a
// library without this symbol takes none (stream right after prefix).
extern "C" int repro_flash_attention_abi() { return 1; }
