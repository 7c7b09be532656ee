// Flash-attention forward (K3): grouped-query attention with an online
// softmax, for prefill.
//
// Replaces the Pallas kernel src/repro/kernels/flash.py:70
// (flash_attention, body _flash_kernel).  It computes the same function:
// q is scaled in float32, logits are float32, an optional tanh softcap
// c*tanh(x/c) follows, the causal mask keeps key t for query s when t <= s
// (both counted from 0), the softmax runs online over key tiles with a
// running max m, sum l and a float32 accumulator, rows with l == 0 divide by
// 1, and the output is cast to the input type.
//
// What differs from the TPU version:
// - GQA: query head h reads K/V of KV head h / (H / KVH) directly; the
//   Pallas wrapper materialises repeat(k, G) in device memory instead.
// - Any S and T: the ragged last query block and key tile are masked here,
//   where the Pallas version asserts S % bq == 0 and T % bk == 0.
// - Blocks run in parallel in no order, so each block owns one (batch,
//   query head, 64-row query block) and loops over key tiles itself; the
//   causal loop stops at the block's last row, and the heaviest causal
//   blocks are scheduled first.
//
// Bound on the H100: operations.  At prefill shapes (S = 2048, hd = 128)
// the two products do ~S/2 multiply-adds per byte of q, k, v and out, far
// above the card's ratio of flops to bytes, so the kernel's business is to
// keep the products on the tensor cores and the logits out of device
// memory.  Two kernels, one contract:
// - bfloat16 with hd >= 16 (the serving path): mma.sync tensor-core
//   products, four warps per 64-row query block, K/V tiles in shared memory
//   (see the tc namespace below).  Synchronous tile loads, no TMA, no wgmma
//   and no warp specialisation yet: that redesign is later work.
// - float32, and hd = 8: the products on the float32 FMA pipes (67 TFLOP/s):
//   a 64 x 64 logits tile per block of 128 threads, each thread holding an
//   8 x 4 block of logits and an 8 x hd/16 block of the output in
//   registers; Q (scaled, float32), K and V staged in shared memory with
//   rows padded so the column-parallel reads hit distinct banks.  The 16
//   threads that share a row group form a half-warp, so row max and row
//   sum are warp shuffles and P passes through shared memory without a
//   block barrier.
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

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

// q, out: (B, S, H, HD); k, v: (B, Tk, KVH, HD); all contiguous.
// grid: (ceil(S / BQ), H, B).
template <typename T, int HD, bool CAUSAL, bool SOFTCAP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int KVH, float scale, float cap) {
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
  const int k_end = CAUSAL ? min(Tk, min(q0 + BQ, S)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
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
        const bool visible = k_pos < Tk && (!CAUSAL || k_pos <= q_pos);
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
  }
}

// --------------------------------------------------------------------------
// bfloat16, hd >= 16: the two products on the tensor cores (mma.sync).
//
// Four warps per 64-row query block, 16 rows each.  Logits: m16n8k16 bf16
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
  static constexpr int BK = HD >= 256 ? 32 : 64;   // keys per tile
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
                     float scale, float cap) {
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

  const int k_end = CAUSAL ? min(Tk, min(q0 + BQ, S)) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
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
        const bool visible = k_pos < Tk && (!CAUSAL || k_pos <= q_pos);
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
  }
}

}  // namespace tc

template <typename T, typename Kernel>
int run(Kernel kernel, size_t smem, const void* q, const void* k, const void* v,
        void* out, int B, int S, int Tk, int H, int KVH, float scale, float cap,
        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(out), S,
                                     Tk, H, KVH, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 with hd >= 16 takes the tensor-core kernel; float32 (whose
// tolerance TF32 would not meet) and hd = 8 the FMA kernel.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int Tk, int H, int KVH, float scale, bool causal, bool softcap,
           float cap, cudaStream_t stream) {
  return with_flag(causal, [&](auto CAUSAL) {
    return with_flag(softcap, [&](auto SOFTCAP) {
      constexpr bool kCausal = decltype(CAUSAL)::value;
      constexpr bool kSoftcap = decltype(SOFTCAP)::value;
      if constexpr (std::is_same_v<T, __nv_bfloat16> && HD >= 16)
        return run<T>(tc::flash_fwd_mma_kernel<HD, kCausal, kSoftcap>, tc::Cfg<HD>::bytes,
                      q, k, v, out, B, S, Tk, H, KVH, scale, cap, stream);
      else
        return run<T>(flash_fwd_kernel<T, HD, kCausal, kSoftcap>, Smem<T, HD>::bytes, q,
                      k, v, out, B, S, Tk, H, KVH, scale, cap, stream);
    });
  });
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out, int B,
             int S, int Tk, int H, int KVH, float scale, bool causal, bool softcap,
             float cap, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap, stream);
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Tk, H, KVH, scale, causal, softcap, cap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
}  // namespace repro

// q, out: (B, S, H, hd); k, v: (B, T, KVH, hd); contiguous, one dtype
// (0 = float32, 2 = bfloat16); H a multiple of KVH; hd in {8, 16, 32, 64,
// 128, 256}.  softcap <= 0 means none.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int S, int T, int H, int KVH,
                                     int hd, int dtype, double scale, double softcap,
                                     int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  if (dtype == 0)
    return repro::flash::dispatch<float>(hd, q, k, v, out, B, S, T, H, KVH, sc,
                                         causal != 0, softcap > 0, cap, s);
  if (dtype == 2)
    return repro::flash::dispatch<__nv_bfloat16>(hd, q, k, v, out, B, S, T, H, KVH, sc,
                                                 causal != 0, softcap > 0, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
