// Flash-attention backward: the gradient of K3 (csrc/flash_attn.cu).
//
// The reference has no TPU kernel for it: its flash attention backward is
// plain jnp inside a jax.custom_vjp (_make_flash's bwd,
// src/repro/models/attention.py:254-319).  This kernel computes that
// gradient of exactly what K3's forward computes: s = scale * (q . k) in
// float32, an optional x = c * tanh(s / c), the causal mask with a window W
// and a bidirectional prefix P (causal_visible), p = exp(x - lse) over the
// visible keys and 0 elsewhere (a row that sees no key has p = 0).  With
// dP = dO V^T, D = rowsum(dO o O) and dS = p (dP - D) (times 1 - tanh^2
// under the softcap), it writes
//   dV = sum over the group of P^T dO,
//   dK = scale * sum over the group of dS^T Q,
//   dQ = scale * dS K.
//
// Three kernels, launched in this order on one stream:
// (a) prep_kernel, one block per (batch, query head, 64-query tile):
//     D = rowsum(dO o O) and each row's lse = m + log l, recomputed over
//     the key tiles the tile sees (K3's forward does not write its row
//     statistics); lse of a row that sees no key is 0 and never read.
// (b) dkdv_kernel, one block per (batch, KV head, 64-key tile): K and V
//     stay in shared memory while the block loops over the G query heads
//     of its group and the query tiles that see its key tile
//     (query_range); dK and dV accumulate in float32 registers over all of
//     them, so no two blocks write the same output and no atomics are
//     needed.
// (c) dq_kernel, one block per (batch, query head, 64-query tile), over the
//     key tiles it sees (key_range).
//
// Products: 8 warps per block; a warp owns 16 rows and half the columns of
// each product.  bfloat16 runs them on the tensor cores with mma.sync
// m16n8k16 (bf16 inputs, float32 sums); p and dS are rounded to bfloat16 in
// shared memory before the products that read them (P^T dO, dS^T Q, dS K).
// Every operand stays row-major in shared memory: a product that reads its
// B operand down the columns (dO and Q in (b), K in (c)) loads the
// fragments with ldmatrix .trans.  Two bf16 blocks fit an SM (88 KB of
// shared memory and at most 128 registers a thread), so one block's
// synchronous tile loads overlap the other's products.  float32 computes
// in float32 on the FMA pipes, in the same fragment layout.
//
// Bound on the H100: operations.  Five products of hd multiply-adds per
// visible (query, key) pair and head (S, dP, dV, dK, dQ; the prep's S
// again is a sixth), against a few bytes per row.  This first version
// issues synchronous loads and mma.sync; TMA, wgmma and lse written by K3's
// epilogue are later work (ROADMAP).
#include <cuda.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace flash_bwd {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NW = 8;         // warps per block
constexpr int NT = 32 * NW;   // threads per block

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int VEC = 4;       // values per 16-byte load
  static constexpr int PAD = 4;       // row pad (values), keeps rows 16-byte aligned
  static constexpr int BLOCKS = 1;    // blocks per SM (__launch_bounds__)
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int PAD = 8;
  static constexpr int BLOCKS = 2;
};

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

// Key t visible to query s: K3's predicate (csrc/flash_attn.cu).
__device__ __forceinline__ bool causal_visible(int t, int s, int window, int prefix) {
  return (t <= s && (window == 0 || t > s - window)) || (t < prefix && s < prefix);
}

struct Range {
  int begin, end;   // empty when begin >= end
};

// The keys that some query of [q0, q1) sees, of Tk keys.
__device__ __forceinline__ Range key_range(int q0, int q1, int Tk, int window, int prefix) {
  int end = min(Tk, q1);
  int begin = window ? max(0, q0 - window + 1) : 0;
  if (q0 < prefix) {
    end = max(end, min(prefix, Tk));
    begin = 0;
  }
  return {begin, end};
}

// The queries, of S, that see some key of [k0, k1): key_range turned
// around.  Query s sees key t on the causal side when t <= s < t + W, so
// the tile's keys are seen by s in [k0, k1 - 1 + W); a tile that starts
// inside the prefix is also seen by every query s < P.  The two intervals
// meet (k0 < P and k0 < S), so their union is one interval.
__device__ __forceinline__ Range query_range(int k0, int k1, int S, int window, int prefix) {
  int begin = k0;
  int end = window ? min(S, k1 - 1 + window) : S;
  if (k0 < prefix) {
    begin = 0;
    end = max(end, min(prefix, S));
  }
  return {begin, end};
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// The fragment layout every product uses (mma.sync m16n8's C): lane
// (g = lane / 4, t = lane % 4) holds acc[f][e] at row g + 8 * (e / 2) and
// column 8 f + 2 t + e % 2 of the warp's 16-row strip.
//   acc[f][e] += sum over k < KD of A[row * lda + k] B(k, col)
// prod_nt takes B(k, n) = B[n * ldb + k] (B^T row-major: bfloat16 reads a
// fragment's pair along k as one 32-bit word); prod_nn takes B(k, n) =
// B[k * ldb + n] (B row-major: bfloat16 loads the fragments with ldmatrix
// .trans, an 8 x 8 block of rows k..k+7 per matrix, each row 16 bytes at a
// 16-byte boundary).  float32 computes the same elements on the FMA pipes.
template <int NF, int KD>
__device__ __forceinline__ void prod_nt(float (&acc)[NF][4], const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const __nv_bfloat16* a = A + g * lda + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * lda), ld32(a + 8), ld32(a + 8 * lda + 8)};
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const __nv_bfloat16* b = B + (f * 8 + g) * ldb + kk * 16 + 2 * t;
      mma_bf16(acc[f], af, ld32(b), ld32(b + 8));
    }
  }
}

template <int NF, int KD>
__device__ __forceinline__ void prod_nn(float (&acc)[NF][4], const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const __nv_bfloat16* a = A + g * lda + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * lda), ld32(a + 8), ld32(a + 8 * lda + 8)};
    // lanes 0-7 address rows k..k+7 (b0), lanes 8-15 rows k+8..k+15 (b1)
    const __nv_bfloat16* row = B + (kk * 16 + (lane & 15)) * ldb;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, row + f * 8);
      mma_bf16(acc[f], af, b0, b1);
    }
  }
}

template <int NF, int KD>
__device__ __forceinline__ void prod_fma(float (&acc)[NF][4], const float* A, int lda,
                                         const float* B, int bn, int bk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* a = A + (g + (e >> 1) * 8) * lda;
      const float* b = B + (f * 8 + 2 * t + (e & 1)) * bn;
      float s = 0.f;
      for (int k = 0; k < KD; ++k) s = fmaf(a[k], b[k * bk], s);
      acc[f][e] += s;
    }
}

template <int NF, int KD>
__device__ __forceinline__ void prod_nt(float (&acc)[NF][4], const float* A, int lda,
                                        const float* B, int ldb) {
  prod_fma<NF, KD>(acc, A, lda, B, ldb, 1);
}

template <int NF, int KD>
__device__ __forceinline__ void prod_nn(float (&acc)[NF][4], const float* A, int lda,
                                        const float* B, int ldb) {
  prod_fma<NF, KD>(acc, A, lda, B, 1, ldb);
}

template <int NF>
__device__ __forceinline__ void zero(float (&acc)[NF][4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
}

// ROWS rows of HD values from src (row r at src + (row0 + r) * stride) into
// dst (row stride LD), 16 bytes per load; rows at or past n_rows are zero.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0,
                                          int n_rows) {
  constexpr int V = Traits<T>::VEC, CH = HD / V;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c * V);
    *reinterpret_cast<uint4*>(dst + r * LD + c * V) = val;
  }
}

// Shared-memory strides: LD for (64, HD) tiles, LDP for the (64, 64)
// tiles of p and dS.  The pads keep rows 16-byte aligned, and make the
// row strides (in 32-bit words) 4 mod 32, so the 8 rows of a fragment or
// an ldmatrix phase fall on distinct banks.
template <typename T, int HD>
struct Dims {
  static constexpr int LD = HD + Traits<T>::PAD;
  static constexpr int LDP = 64 + Traits<T>::PAD;
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  static constexpr size_t ptile = sizeof(T) * 64 * LDP;
  static constexpr size_t rows = sizeof(float) * 64;
  // prep: Q, K; the two column halves' (m, l) per row
  static constexpr size_t prep_bytes = 2 * tile + 4 * rows;
  // dkdv: K, V, Q, dO, P^T, dS^T, lse, D
  static constexpr size_t dkdv_bytes = 4 * tile + 2 * ptile + 2 * rows;
  // dq: Q, dO, K, V, dS, lse, D
  static constexpr size_t dq_bytes = 4 * tile + ptile + 2 * rows;
};

// p, dS of one logits element: x = scale * acc (then the softcap), visible
// or not; p = exp(x - lse), dS = p (dP - D) (1 - tanh^2).
template <bool SOFTCAP>
__device__ __forceinline__ void p_ds(float acc, float dp, float lse, float dl, bool vis,
                                     float scale, float cap, float& p, float& ds) {
  float x = acc * scale, dcap = 1.f;
  if constexpr (SOFTCAP) {
    const float th = tanhf(x / cap);
    x = cap * th;
    dcap = 1.f - th * th;
  }
  p = vis ? expf(x - lse) : 0.f;
  ds = p * (dp - dl) * dcap;
}

// (a) D and lse.  grid: (ceil(S / BQ), H, B).
template <typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, Traits<T>::BLOCKS)
prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
            const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ dlt,
            int S, int Tk, int H, int KVH, float scale, float cap, int window, int prefix) {
  using D = Dims<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + 64 * D::LD;
  float* red = reinterpret_cast<float*>(Ks + 64 * D::LD);   // m0, l0, m1, l1 per row

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rr = (w & 3) * 16, lc = (w >> 2) * 32;
  const long long qs = static_cast<long long>(H) * HD, ks = static_cast<long long>(KVH) * HD;
  const long long qoff = (static_cast<long long>(b) * S * H + h) * HD;
  const T* kh = k + (static_cast<long long>(b) * Tk * KVH + kvh) * HD;
  float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
  float* dlt_h = dlt + (static_cast<long long>(b) * H + h) * S;

  // D = rowsum(dO o O): a warp per row, lanes over the columns
  for (int r = w; r < BQ; r += NW) {
    const int s = q0 + r;
    if (s >= S) break;
    float acc = 0.f;
    for (int d = lane; d < HD; d += 32)
      acc += to_float(o[qoff + s * qs + d]) * to_float(dout[qoff + s * qs + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) dlt_h[s] = acc;
  }

  load_tile<T, HD, BQ, D::LD>(Qs, q + qoff, qs, q0, S);
  // this thread's running max and sum over its columns, rows rr + g and rr + g + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const Range kr = key_range(q0, min(q0 + BQ, S), Tk, window, prefix);
  for (int k0 = kr.begin / BK * BK; k0 < kr.end; k0 += BK) {
    __syncthreads();
    load_tile<T, HD, BK, D::LD>(Ks, kh, ks, k0, Tk);
    __syncthreads();
    float sc[4][4];
    zero(sc);
    prod_nt<4, HD>(sc, Qs + rr * D::LD, D::LD, Ks + lc * D::LD, D::LD);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = q0 + rr + g + (e >> 1) * 8, key = k0 + lc + f * 8 + 2 * t + (e & 1);
        float x = sc[f][e] * scale;
        if constexpr (SOFTCAP) x = cap * tanhf(x / cap);
        const bool vis = s < S && key < Tk && causal_visible(key, s, window, prefix);
        sc[f][e] = vis ? x : -CUDART_INF_F;
        mt[e >> 1] = fmaxf(mt[e >> 1], sc[f][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], mt[r]);
      if (mn == -CUDART_INF_F) continue;     // nothing visible yet
      float sum = 0.f;
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          if (sc[f][e] != -CUDART_INF_F) sum += expf(sc[f][e] - mn);
      l[r] = l[r] * expf(m[r] - mn) + sum;   // exp(-inf) = 0 for the first
      m[r] = mn;
    }
  }
  // merge the four lanes of a row, then the two column halves
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      if (mn != -CUDART_INF_F) l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
      m[r] = mn;
    }
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rr + g + r * 8, half = w >> 2;
      red[(2 * half) * BQ + row] = m[r];
      red[(2 * half + 1) * BQ + row] = l[r];
    }
  __syncthreads();
  for (int row = threadIdx.x; row < BQ && q0 + row < S; row += NT) {
    const float m0 = red[row], l0 = red[BQ + row], m1 = red[2 * BQ + row],
                l1 = red[3 * BQ + row];
    const float mn = fmaxf(m0, m1);
    float out = 0.f;                         // a row that sees no key
    if (mn != -CUDART_INF_F) out = mn + logf(l0 * expf(m0 - mn) + l1 * expf(m1 - mn));
    lse_h[q0 + row] = out;
  }
}

// (b) dK, dV.  grid: (ceil(Tk / BK), KVH, B); the first key tiles, which
// the most queries see under the causal mask, are scheduled first.
template <typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, Traits<T>::BLOCKS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dlt, T* __restrict__ dk, T* __restrict__ dv, int S,
            int Tk, int H, int KVH, float scale, float cap, int window, int prefix) {
  using D = Dims<T, HD>;
  constexpr int LD = D::LD, LDP = D::LDP, NO = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + 64 * LD;
  T* Qs = Vs + 64 * LD;
  T* dOs = Qs + 64 * LD;
  T* PT = dOs + 64 * LD;                      // p^T: (key, query)
  T* dST = PT + 64 * LDP;                     // dS^T
  float* lse_s = reinterpret_cast<float*>(dST + 64 * LDP);
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rr = (w & 3) * 16, lc = (w >> 2) * 32, oc = (w >> 2) * (HD / 2);
  const long long qs = static_cast<long long>(H) * HD, ks = static_cast<long long>(KVH) * HD;
  const long long koff = (static_cast<long long>(b) * Tk * KVH + kvh) * HD;

  load_tile<T, HD, BK, LD>(Ks, k + koff, ks, k0, Tk);
  load_tile<T, HD, BK, LD>(Vs, v + koff, ks, k0, Tk);
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  const Range qr = query_range(k0, min(k0 + BK, Tk), S, window, prefix);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const long long qoff = (static_cast<long long>(b) * S * H + h) * HD;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
    const float* dlt_h = dlt + (static_cast<long long>(b) * H + h) * S;
    for (int q0 = qr.begin / BQ * BQ; q0 < qr.end; q0 += BQ) {
      __syncthreads();   // the previous tile's products are done
      load_tile<T, HD, BQ, LD>(Qs, q + qoff, qs, q0, S);
      load_tile<T, HD, BQ, LD>(dOs, dout + qoff, qs, q0, S);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const bool in = q0 + i < S;
        lse_s[i] = in ? lse_h[q0 + i] : 0.f;
        dl_s[i] = in ? dlt_h[q0 + i] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
      prod_nt<4, HD>(st, Ks + rr * LD, LD, Qs + lc * LD, LD);     // S^T
      prod_nt<4, HD>(dpt, Vs + rr * LD, LD, dOs + lc * LD, LD);   // dP^T
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = rr + g + (e >> 1) * 8, i = lc + f * 8 + 2 * t + (e & 1);
          const bool vis = k0 + j < Tk && q0 + i < S &&
                           causal_visible(k0 + j, q0 + i, window, prefix);
          float p, ds;
          p_ds<SOFTCAP>(st[f][e], dpt[f][e], lse_s[i], dl_s[i], vis, scale, cap, p, ds);
          PT[j * LDP + i] = from_float<T>(p);
          dST[j * LDP + i] = from_float<T>(ds);
        }
      __syncthreads();
      prod_nn<NO, BQ>(dv_acc, PT + rr * LDP, LDP, dOs + oc, LD);   // P^T dO
      prod_nn<NO, BQ>(dk_acc, dST + rr * LDP, LDP, Qs + oc, LD);   // dS^T Q
    }
  }
#pragma unroll
  for (int f = 0; f < NO; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = rr + g + (e >> 1) * 8, d = oc + f * 8 + 2 * t + (e & 1);
      if (k0 + j >= Tk) continue;
      const long long at = koff + (k0 + j) * ks + d;
      dk[at] = from_float<T>(dk_acc[f][e] * scale);
      dv[at] = from_float<T>(dv_acc[f][e]);
    }
}

// (c) dQ.  grid: (ceil(S / BQ), H, B); the last query tiles, which see the
// most keys under the causal mask, are scheduled first.
template <typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, Traits<T>::BLOCKS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dlt, T* __restrict__ dq, int S, int Tk, int H, int KVH,
          float scale, float cap, int window, int prefix) {
  using D = Dims<T, HD>;
  constexpr int LD = D::LD, LDP = D::LDP, NO = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + 64 * LD;
  T* Ks = dOs + 64 * LD;
  T* Vs = Ks + 64 * LD;
  T* dSs = Vs + 64 * LD;                      // dS: (query, key)
  float* lse_s = reinterpret_cast<float*>(dSs + 64 * LDP);
  float* dl_s = lse_s + BQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rr = (w & 3) * 16, lc = (w >> 2) * 32, oc = (w >> 2) * (HD / 2);
  const long long qs = static_cast<long long>(H) * HD, ks = static_cast<long long>(KVH) * HD;
  const long long qoff = (static_cast<long long>(b) * S * H + h) * HD;
  const long long koff = (static_cast<long long>(b) * Tk * KVH + kvh) * HD;
  const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
  const float* dlt_h = dlt + (static_cast<long long>(b) * H + h) * S;

  load_tile<T, HD, BQ, LD>(Qs, q + qoff, qs, q0, S);
  load_tile<T, HD, BQ, LD>(dOs, dout + qoff, qs, q0, S);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const bool in = q0 + i < S;
    lse_s[i] = in ? lse_h[q0 + i] : 0.f;
    dl_s[i] = in ? dlt_h[q0 + i] : 0.f;
  }
  float dq_acc[NO][4];
  zero(dq_acc);

  const Range kr = key_range(q0, min(q0 + BQ, S), Tk, window, prefix);
  for (int k0 = kr.begin / BK * BK; k0 < kr.end; k0 += BK) {
    __syncthreads();
    load_tile<T, HD, BK, LD>(Ks, k + koff, ks, k0, Tk);
    load_tile<T, HD, BK, LD>(Vs, v + koff, ks, k0, Tk);
    __syncthreads();
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    prod_nt<4, HD>(sc, Qs + rr * LD, LD, Ks + lc * LD, LD);    // S
    prod_nt<4, HD>(dp, dOs + rr * LD, LD, Vs + lc * LD, LD);   // dP
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rr + g + (e >> 1) * 8, j = lc + f * 8 + 2 * t + (e & 1);
        const bool vis = q0 + i < S && k0 + j < Tk &&
                         causal_visible(k0 + j, q0 + i, window, prefix);
        float p, ds;
        p_ds<SOFTCAP>(sc[f][e], dp[f][e], lse_s[i], dl_s[i], vis, scale, cap, p, ds);
        dSs[i * LDP + j] = from_float<T>(ds);
      }
    __syncthreads();
    prod_nn<NO, BK>(dq_acc, dSs + rr * LDP, LDP, Ks + oc, LD);   // dS K
  }
#pragma unroll
  for (int f = 0; f < NO; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rr + g + (e >> 1) * 8, d = oc + f * 8 + 2 * t + (e & 1);
      if (q0 + i < S) dq[qoff + (q0 + i) * qs + d] = from_float<T>(dq_acc[f][e] * scale);
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int HD, bool SOFTCAP>
int launch(const void* q_, const void* k_, const void* v_, const void* o_, const void* do_,
           void* dq_, void* dk_, void* dv_, float* lse, float* dlt, int B, int S, int Tk,
           int H, int KVH, float scale, float cap, int window, int prefix,
           cudaStream_t stream) {
  using D = Dims<T, HD>;
  const T *q = static_cast<const T*>(q_), *k = static_cast<const T*>(k_),
          *v = static_cast<const T*>(v_), *o = static_cast<const T*>(o_),
          *dout = static_cast<const T*>(do_);
  auto prep = prep_kernel<T, HD, SOFTCAP>;
  auto dkdv = dkdv_kernel<T, HD, SOFTCAP>;
  auto dqk = dq_kernel<T, HD, SOFTCAP>;
  cudaError_t err;
  if ((err = allow_smem(prep, D::prep_bytes)) != cudaSuccess ||
      (err = allow_smem(dkdv, D::dkdv_bytes)) != cudaSuccess ||
      (err = allow_smem(dqk, D::dq_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 qgrid((S + BQ - 1) / BQ, H, B), kgrid((Tk + BK - 1) / BK, KVH, B);
  prep<<<qgrid, NT, D::prep_bytes, stream>>>(q, k, o, dout, lse, dlt, S, Tk, H, KVH, scale,
                                            cap, window, prefix);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dkdv<<<kgrid, NT, D::dkdv_bytes, stream>>>(q, k, v, dout, lse, dlt, static_cast<T*>(dk_),
                                             static_cast<T*>(dv_), S, Tk, H, KVH, scale,
                                             cap, window, prefix);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dqk<<<qgrid, NT, D::dq_bytes, stream>>>(q, k, v, dout, lse, dlt, static_cast<T*>(dq_), S,
                                          Tk, H, KVH, scale, cap, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, bool softcap, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* dlt, int B, int S, int Tk, int H, int KVH, float scale, float cap,
             int window, int prefix, cudaStream_t stream) {
  return with_flag(softcap, [&](auto SOFTCAP) {
    constexpr bool kCap = decltype(SOFTCAP)::value;
    switch (hd) {
      case 16:
        return launch<T, 16, kCap>(q, k, v, o, dout, dq, dk, dv, lse, dlt, B, S, Tk, H, KVH,
                                   scale, cap, window, prefix, stream);
      case 32:
        return launch<T, 32, kCap>(q, k, v, o, dout, dq, dk, dv, lse, dlt, B, S, Tk, H, KVH,
                                   scale, cap, window, prefix, stream);
      case 64:
        return launch<T, 64, kCap>(q, k, v, o, dout, dq, dk, dv, lse, dlt, B, S, Tk, H, KVH,
                                   scale, cap, window, prefix, stream);
      case 128:
        return launch<T, 128, kCap>(q, k, v, o, dout, dq, dk, dv, lse, dlt, B, S, Tk, H,
                                    KVH, scale, cap, window, prefix, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // namespace flash_bwd
}  // namespace repro

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, KVH, hd); contiguous,
// one dtype (0 = float32, 2 = bfloat16); H a multiple of KVH; hd in {16, 32,
// 64, 128}; the causal mask, window > 0 keeping keys t > s - window and
// prefix > 0 opening the prefix's square (0: none); softcap <= 0 means none.
// lse and delta: (B, H, S) float32 scratch.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int B, int S,
                                         int T, int H, int KVH, int hd, int dtype,
                                         double scale, double softcap, int window,
                                         int prefix, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T <= 0 || window < 0 || prefix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  auto* l = static_cast<float*>(lse);
  auto* d = static_cast<float*>(delta);
  if (dtype == 0)
    return repro::flash_bwd::dispatch<float>(hd, softcap > 0, q, k, v, o, dout, dq, dk, dv, l,
                                             d, B, S, T, H, KVH, sc, cap, window, prefix, s);
  if (dtype == 2)
    return repro::flash_bwd::dispatch<__nv_bfloat16>(hd, softcap > 0, q, k, v, o, dout, dq,
                                                     dk, dv, l, d, B, S, T, H, KVH, sc, cap,
                                                     window, prefix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
