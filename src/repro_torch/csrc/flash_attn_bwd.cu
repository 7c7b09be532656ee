// Flash-attention backward: the gradient of K3 (csrc/flash_attn.cu).
//
// The reference has no TPU kernel for it: its flash attention backward is
// plain jnp inside a jax.custom_vjp (_make_flash's bwd,
// src/repro/models/attention.py:254-319).  This kernel computes that
// gradient of exactly what K3's forward computes: s = scale * (q . k) in
// float32, an optional x = c * tanh(s / c), the causal mask with a window W
// and a bidirectional prefix P (causal_visible), p = exp(x - lse) over the
// visible keys and 0 elsewhere (a row that sees no key has p = 0).  lse is
// each row's log-sum-exp, written by K3's forward (its lse output), as the
// reference's bwd reads the forward's m and l.  With dP = dO V^T,
// D = rowsum(dO o O) and dS = p (dP - D) (times 1 - tanh^2 under the
// softcap), it writes
//   dV = sum over the group of P^T dO,
//   dK = scale * sum over the group of dS^T Q,
//   dQ = scale * dS K.
// p and dS are rounded to bfloat16 before the products that read them, as
// the reference does (attention.py:305-306).
//
// Bound on the H100: operations.  Five products of hd multiply-adds per
// visible (query, key) pair and head (S, dP, dV, dK, dQ) against a few
// bytes per row.
//
// First, for every path, prep_kernel: D = rowsum(dO o O) and a copy of the
// forward's lse, both as (B, H, Sp) float32 rows padded to Sp, a multiple
// of 64 (zeros past S), so that a 64-row tile of either is one aligned
// 256-byte bulk copy.  No logits are computed there.
//
// bfloat16 at hd 64, 80, 128 and 256 (musicgen, zamba2's shared block,
// starcoder2 and deepseek, gemma2 and paligemma) -- namespace hopper, in
// the manner of K3's Hopper forward, built from hopper.cuh (TMA with the
// 128-byte swizzle, hd 80 as a 64-column and a 16-column chunk, wgmma):
// (a) dkdv_wgmma_kernel, one block per (batch, query head, 128-key tile;
//     64 keys at hd 256, where both consumer warpgroups take the same keys
//     and half of dK's and dV's columns each, Cfg::SPLIT):
//     K and V of the tile are loaded once by TMA; a producer warp streams
//     the 64-query tiles of Q and dO that see the key tile (query_range),
//     with their rows' lse and D (bulk copies), through a ring of
//     mbarrier-guarded stages (3; 2 at hd 256).  Two consumer warpgroups
//     own 64 keys each: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared
//     memory), p and dS^T in registers, then dV += P^T dO and dK += dS^T Q
//     (wgmma with p and dS^T as register A operands and Q, dO read
//     MN-major from the same tiles).  dK and dV accumulate in float32
//     registers and go, per query head, to a float32 (B, T, H, hd)
//     workspace.  At hd 64 and 80 a tile's p and dS are computed while the
//     previous tile's dV and dK products run.
// (b) dq_wgmma_kernel, one block per (batch, query head, 128-query block),
//     K3's forward turned to dQ: Q and dO loaded once, K and V through the
//     ring in 64-key tiles (key_range); S = Q K^T and dP = dO V^T, dS in
//     registers, dQ += dS K (K read MN-major), each tile's dS computed
//     while the previous tile's dQ product runs (at hd 256, where one
//     stage fits, in turn).
// (c) group_sum_kernel: dK = scale * sum over the G query heads of each KV
//     head, dV the same sum, in head order, cast to bfloat16.
// Why dQ is a kernel of its own (7 products per pair, not 5): it keeps
// every sum in a fixed order, so the gradients repeat bit for bit, where
// accumulating dQ in (a) by atomics would add each key tile's part in
// whatever order the blocks run.  Why the group is split across blocks:
// a dK/dV block that walks all G query heads of its KV head and every
// query tile that sees its key tile runs 768 tile iterations for
// starcoder2's first key tile (G = 12) against 384 on average, in a grid
// of 256 blocks that the card holds at once, so the first key tiles set
// the kernel's time (the mma.sync kernel below).  One block per query
// head makes G times as many blocks, the longest 64 iterations, and the
// grid runs the first key tiles (the most work under the causal mask)
// first; the price is the float32 workspace (2 x 100.7 MB at starcoder2's
// layer) and the small pass (c) that sums it in a fixed order (a G = 1
// head writes bfloat16 directly).  Registers: the consumers hold dK and dV
// (hd / 2 floats each), S^T and dP^T (32 each) and the bf16 fragments of
// p and dS (16 each) at setmaxnreg 240; every branch around a wgmma is
// warp-uniform.
//
// float32 (every width; 1e-5 needs float32 products) and bfloat16 at hd 16
// and 32 (the smoke configs) -- namespace mma, synchronous loads and
// mma.sync: dkdv_kernel, one block per
// (batch, KV head, 64-key tile), walks the G query heads and the query
// tiles that see its tile, dK and dV in float32 registers, no atomics;
// dq_kernel, one block per (batch, query head, 64-query tile).  8 warps, a
// warp owning 16 rows and half the columns of each product; bfloat16 on
// mma.sync m16n8k16 with ldmatrix .trans for the B operands read down
// their columns, float32 on the FMA pipes in the same fragment layout.
// float32 at hd 256 takes 32-query tiles in dkdv_kernel and 32-key tiles in
// dq_kernel to stay within 227 KB of shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace flash_bwd {

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

constexpr int ROWS = 64;        // prep: rows per block (8 warps, 8 rows each)

// Four consecutive values as floats (8 or 16 bytes, aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// D = rowsum(dO o O) and the forward's lse, as (B, H, Sp) rows with zeros
// past S.  grid: (Sp / ROWS, H, B); a warp per row, lanes over the columns
// four at a time (HD is a multiple of 4).
template <typename T>
__global__ void __launch_bounds__(256)
prep_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
            float* __restrict__ lse_p, float* __restrict__ dlt, int S, int Sp, int H, int HD) {
  const int h = blockIdx.y, b = blockIdx.z, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qs = static_cast<long long>(H) * HD;
  const long long qoff = (static_cast<long long>(b) * S * H + h) * HD;
  const long long row0 = (static_cast<long long>(b) * H + h);
  for (int r = w; r < ROWS; r += 8) {
    const int s = blockIdx.x * ROWS + r;
    float acc = 0.f;
    if (s < S)
      for (int d = 4 * lane; d < HD; d += 128) {
        const float4 x = load4(o + qoff + s * qs + d), y = load4(dout + qoff + s * qs + d);
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      dlt[row0 * Sp + s] = acc;
      lse_p[row0 * Sp + s] = s < S ? lse[row0 * S + s] : 0.f;
    }
  }
}

// --------------------------------------------------------------------------
// float32, and bfloat16 at hd 16 and 32: mma.sync / FMA kernels.
// --------------------------------------------------------------------------
namespace mma {

constexpr int NW = 8;         // warps per block
constexpr int NT = 32 * NW;   // threads per block

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int VEC = 4;       // values per 16-byte load
  static constexpr int PAD = 4;       // row pad (values), keeps rows 16-byte aligned
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int PAD = 8;
};

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
template <typename T, int HD, int NROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0,
                                          int n_rows) {
  constexpr int V = Traits<T>::VEC, CH = HD / V;
  for (int i = threadIdx.x; i < NROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c * V);
    *reinterpret_cast<uint4*>(dst + r * LD + c * V) = val;
  }
}

// Tiles and shared memory.  dkdv_kernel holds 64 keys and loops over QT
// queries at a time, dq_kernel holds 64 queries and loops over QT keys at a
// time; QT is 64, or 32 for float32 at hd 256 (which would not fit 227 KB
// with 64).  LD is the row stride of a (rows, HD) tile, LDP that of the
// (64, QT) tiles of p and dS; the pads keep rows 16-byte aligned and make
// the row strides (in 32-bit words) 4 mod 32, so the 8 rows of a fragment
// or an ldmatrix phase fall on distinct banks.  Two bfloat16 blocks fit an
// SM at hd <= 128 (88 KB and at most 128 registers a thread each).
template <typename T, int HD>
struct Dims {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int QT = F32 && HD > 128 ? 32 : 64;
  static constexpr int BLOCKS = !F32 && HD <= 128 ? 2 : 1;
  static constexpr int LD = HD + Traits<T>::PAD;
  static constexpr int LDP = QT + Traits<T>::PAD;
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  static constexpr size_t qtile = sizeof(T) * QT * LD;
  static constexpr size_t ptile = sizeof(T) * 64 * LDP;
  // dkdv: K, V, Q, dO, P^T, dS^T, lse, D
  static constexpr size_t dkdv_bytes = 2 * tile + 2 * qtile + 2 * ptile + 2 * sizeof(float) * QT;
  // dq: Q, dO, K, V, dS, lse, D
  static constexpr size_t dq_bytes = 2 * tile + 2 * qtile + ptile + 2 * sizeof(float) * 64;
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

// dK, dV.  grid: (ceil(Tk / 64), KVH, B); the first key tiles, which the
// most queries see under the causal mask, are scheduled first.  lse and dlt
// are (B, H, Sp).
template <typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, (Dims<T, HD>::BLOCKS))
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dlt, T* __restrict__ dk, T* __restrict__ dv, int S, int Sp,
            int Tk, int H, int KVH, float scale, float cap, int window, int prefix) {
  using D = Dims<T, HD>;
  constexpr int LD = D::LD, LDP = D::LDP, QT = D::QT, NF = QT / 16, NO = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + 64 * LD;
  T* Qs = Vs + 64 * LD;
  T* dOs = Qs + QT * LD;
  T* PT = dOs + QT * LD;                      // p^T: (key, query)
  T* dST = PT + 64 * LDP;                     // dS^T
  float* lse_s = reinterpret_cast<float*>(dST + 64 * LDP);
  float* dl_s = lse_s + QT;

  const int k0 = blockIdx.x * 64, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rr = (w & 3) * 16, lc = (w >> 2) * (QT / 2), oc = (w >> 2) * (HD / 2);
  const long long qs = static_cast<long long>(H) * HD, ks = static_cast<long long>(KVH) * HD;
  const long long koff = (static_cast<long long>(b) * Tk * KVH + kvh) * HD;

  load_tile<T, HD, 64, LD>(Ks, k + koff, ks, k0, Tk);
  load_tile<T, HD, 64, LD>(Vs, v + koff, ks, k0, Tk);
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  const Range qr = query_range(k0, min(k0 + 64, Tk), S, window, prefix);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const long long qoff = (static_cast<long long>(b) * S * H + h) * HD;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Sp;
    const float* dlt_h = dlt + (static_cast<long long>(b) * H + h) * Sp;
    for (int q0 = qr.begin / QT * QT; q0 < qr.end; q0 += QT) {
      __syncthreads();   // the previous tile's products are done
      load_tile<T, HD, QT, LD>(Qs, q + qoff, qs, q0, S);
      load_tile<T, HD, QT, LD>(dOs, dout + qoff, qs, q0, S);
      for (int i = threadIdx.x; i < QT; i += NT) {
        const bool in = q0 + i < S;
        lse_s[i] = in ? lse_h[q0 + i] : 0.f;
        dl_s[i] = in ? dlt_h[q0 + i] : 0.f;
      }
      __syncthreads();
      float st[NF][4], dpt[NF][4];
      zero(st);
      zero(dpt);
      prod_nt<NF, HD>(st, Ks + rr * LD, LD, Qs + lc * LD, LD);     // S^T
      prod_nt<NF, HD>(dpt, Vs + rr * LD, LD, dOs + lc * LD, LD);   // dP^T
#pragma unroll
      for (int f = 0; f < NF; ++f)
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
      prod_nn<NO, QT>(dv_acc, PT + rr * LDP, LDP, dOs + oc, LD);   // P^T dO
      prod_nn<NO, QT>(dk_acc, dST + rr * LDP, LDP, Qs + oc, LD);   // dS^T Q
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

// dQ.  grid: (ceil(S / 64), H, B); the last query tiles, which see the most
// keys under the causal mask, are scheduled first.
template <typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, (Dims<T, HD>::BLOCKS))
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dlt, T* __restrict__ dq, int S, int Sp, int Tk, int H,
          int KVH, float scale, float cap, int window, int prefix) {
  using D = Dims<T, HD>;
  constexpr int LD = D::LD, LDP = D::LDP, KT = D::QT, NF = KT / 16, NO = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + 64 * LD;
  T* Ks = dOs + 64 * LD;
  T* Vs = Ks + KT * LD;
  T* dSs = Vs + KT * LD;                      // dS: (query, key)
  float* lse_s = reinterpret_cast<float*>(dSs + 64 * LDP);
  float* dl_s = lse_s + 64;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rr = (w & 3) * 16, lc = (w >> 2) * (KT / 2), oc = (w >> 2) * (HD / 2);
  const long long qs = static_cast<long long>(H) * HD, ks = static_cast<long long>(KVH) * HD;
  const long long qoff = (static_cast<long long>(b) * S * H + h) * HD;
  const long long koff = (static_cast<long long>(b) * Tk * KVH + kvh) * HD;
  const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Sp;
  const float* dlt_h = dlt + (static_cast<long long>(b) * H + h) * Sp;

  load_tile<T, HD, 64, LD>(Qs, q + qoff, qs, q0, S);
  load_tile<T, HD, 64, LD>(dOs, dout + qoff, qs, q0, S);
  for (int i = threadIdx.x; i < 64; i += NT) {
    const bool in = q0 + i < S;
    lse_s[i] = in ? lse_h[q0 + i] : 0.f;
    dl_s[i] = in ? dlt_h[q0 + i] : 0.f;
  }
  float dq_acc[NO][4];
  zero(dq_acc);

  const Range kr = key_range(q0, min(q0 + 64, S), Tk, window, prefix);
  for (int k0 = kr.begin / KT * KT; k0 < kr.end; k0 += KT) {
    __syncthreads();
    load_tile<T, HD, KT, LD>(Ks, k + koff, ks, k0, Tk);
    load_tile<T, HD, KT, LD>(Vs, v + koff, ks, k0, Tk);
    __syncthreads();
    float sc[NF][4], dp[NF][4];
    zero(sc);
    zero(dp);
    prod_nt<NF, HD>(sc, Qs + rr * LD, LD, Ks + lc * LD, LD);    // S
    prod_nt<NF, HD>(dp, dOs + rr * LD, LD, Vs + lc * LD, LD);   // dP
#pragma unroll
    for (int f = 0; f < NF; ++f)
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
    prod_nn<NO, KT>(dq_acc, dSs + rr * LDP, LDP, Ks + oc, LD);   // dS K
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
int launch(const T* q, const T* k, const T* v, const T* dout, const float* lse,
           const float* dlt, T* dq, T* dk, T* dv, int B, int S, int Sp, int Tk, int H, int KVH,
           float scale, float cap, int window, int prefix, cudaStream_t stream) {
  using D = Dims<T, HD>;
  auto dkdv = dkdv_kernel<T, HD, SOFTCAP>;
  auto dqk = dq_kernel<T, HD, SOFTCAP>;
  cudaError_t err;
  if ((err = allow_smem(dkdv, D::dkdv_bytes)) != cudaSuccess ||
      (err = allow_smem(dqk, D::dq_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 qgrid((S + 63) / 64, H, B), kgrid((Tk + 63) / 64, KVH, B);
  dkdv<<<kgrid, NT, D::dkdv_bytes, stream>>>(q, k, v, dout, lse, dlt, dk, dv, S, Sp, Tk, H, KVH,
                                             scale, cap, window, prefix);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dqk<<<qgrid, NT, D::dq_bytes, stream>>>(q, k, v, dout, lse, dlt, dq, S, Sp, Tk, H, KVH, scale,
                                          cap, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// --------------------------------------------------------------------------
// bfloat16, hd in {64, 80, 128, 256}: the Hopper kernels (TMA, mbarriers,
// wgmma, warp specialisation), in the layout of hopper.cuh.
//
// Both kernels: 384 threads, warpgroup 0 the producer (setmaxnreg 24, one
// thread issues every TMA load), warpgroups 1 and 2 the consumers
// (setmaxnreg 240), 64 rows each (at hd 256 in dK/dV the same 64 keys,
// each warpgroup owning half of dK's and dV's columns: see Cfg::SPLIT).
// Ring position i sits in stage i % the ring's depth; its "full" barrier
// counts the producer's arrive.expect_tx
// and the bytes, its "empty" barrier one arrival from each of the 8
// consumer warps once the products that read the stage are done.  A
// consumer's accumulator entry 4j + e (wgmma m64nN) is row 16w + g +
// 8(e / 2), column 8j + 2t + e % 2 of its 64 rows (w its warp, lane 4g + t).
// --------------------------------------------------------------------------
namespace hopper {

using namespace sm90;

constexpr int NT = 384;     // threads per block
constexpr int QT = 64;      // dK/dV: queries per ring tile
constexpr int QB = 128;     // dQ: query rows per block, 64 per consumer warpgroup
constexpr int KT = 64;      // dQ: keys per ring tile

template <int HD>
struct Cfg {
  static constexpr int NCH = HD / CW;                          // 128-byte chunks
  static constexpr bool TAIL = HD % CW != 0;                   // a 16-column chunk
  static_assert(HD % CW == 0 || HD % CW == TW, "hd: 64-column chunks and one 16-column tail");
  static constexpr int ROW = HD * 2;                           // bytes per row
  // At hd 256 one warpgroup cannot hold dK and dV of 64 keys (256 float32
  // registers a thread), so both consumer warpgroups take the same 64 keys,
  // each computing S^T and dP^T whole, and each accumulates half of dK's
  // and dV's columns; elsewhere each owns 64 of the block's 128 keys.
  static constexpr bool SPLIT = HD > 128;
  static constexpr int KB = SPLIT ? 64 : 128;                  // dK/dV: keys per block
  static constexpr int COLS = SPLIT ? HD / 2 : HD;             // dK, dV columns a warpgroup
  // Ring depths, within 227 KB: a pipelined loop holds a tile until the
  // next tile's products are issued, so it wants 3 stages
  static constexpr int KV_STAGES = SPLIT ? 2 : 3;
  static constexpr int DQ_STAGES = SPLIT ? 1 : 3;
  // Whether a tile's math overlaps the previous tile's products: at hd 128
  // and 256 dK and dV take 128 registers, and keeping p's and dS's
  // fragments alive across the next tile's math spills and serialises the
  // wgmmas; dQ needs a second stage
  static constexpr bool KV_PIPE = HD <= 80;
  static constexpr bool DQ_PIPE = DQ_STAGES > 1;
  // dK/dV: K and V (KB rows), a ring of (Q, dO) tiles of QT rows and of
  // their rows' (lse, D), barriers: kv_full, full and empty per stage
  static constexpr int KV_BYTES = KB * ROW;
  static constexpr int QT_BYTES = QT * ROW;
  static constexpr int STAT_BYTES = QT * 4;
  static constexpr int DKDV_RING = 2 * KV_BYTES;
  static constexpr int DKDV_STAT = DKDV_RING + KV_STAGES * 2 * QT_BYTES;
  static constexpr int DKDV_BAR = DKDV_STAT + KV_STAGES * 2 * STAT_BYTES;
  static constexpr size_t dkdv_bytes = DKDV_BAR + 8 * (1 + 2 * KV_STAGES) + 1024;
  // dQ: Q and dO (QB rows), a ring of (K, V) tiles of KT rows, barriers:
  // q_full, full and empty per stage
  static constexpr int QB_BYTES = QB * ROW;
  static constexpr int KT_BYTES = KT * ROW;
  static constexpr int DQ_RING = 2 * QB_BYTES;
  static constexpr int DQ_BAR = DQ_RING + DQ_STAGES * 2 * KT_BYTES;
  static constexpr size_t dq_bytes = DQ_BAR + 8 * (1 + 2 * DQ_STAGES) + 1024;
  static_assert(dkdv_bytes <= 232448 && dq_bytes <= 232448, "227 KB of shared memory");
};

// Whether every key of [k0, k0 + 64) is visible to every query of
// [q0, q0 + 64): both inside their lengths, and the block below the
// diagonal and above the window of every query, or in the prefix's square.
__device__ __forceinline__ bool all_visible(int k0, int q0, int S, int Tk, int window,
                                            int prefix) {
  if (q0 + 64 > S || k0 + 64 > Tk) return false;
  return (k0 + 63 <= q0 && (window == 0 || q0 + 63 < k0 + window)) ||
         (k0 + 64 <= prefix && q0 + 64 <= prefix);
}

// p and dS of one 64-key x 64-query tile of dK/dV, in place: s holds S^T =
// K Q^T, dp holds dP^T = V dO^T; the thread's keys (rows) are key[0] and
// key[1], the query of s[i] is q0 + 8 (i / 4) + 2t + i % 2, whose lse and D
// are lse_s[c] and dl_s[c] (c the query less q0; shared memory).  Key t is
// visible to the queries [t, t + W) (to S, or [t, S) with no window) and,
// for t < P, to [0, P).  On return s holds p (0 where hidden) and dp holds
// dS = p (dP - D) (1 - tanh^2).
template <bool MASK, bool SOFTCAP>
__device__ __forceinline__ void p_ds_keys(float (&s)[QT / 2], float (&dp)[QT / 2],
                                          const float* lse_s, const float* dl_s, int q0,
                                          const int (&key)[2], int t, int S, int Tk, int window,
                                          int prefix, float scale_log2, float scale, float cap) {
  int lo[2], hi[2], pe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = key[r] < Tk;
    lo[r] = key[r];
    hi[r] = !in ? key[r] : window ? min(S, key[r] + window) : S;
    pe[r] = in && key[r] < prefix ? min(prefix, S) : 0;
  }
#pragma unroll
  for (int j = 0; j < QT / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1;
      const float lse = (e & 1 ? l2.y : l2.x) * LOG2E, dl = e & 1 ? d2.y : d2.x;
      float x, dcap = 1.f;
      if constexpr (SOFTCAP) {
        const float th = tanhf(s[i] * scale / cap);
        x = cap * th * LOG2E;
        dcap = 1.f - th * th;
      } else {
        x = s[i] * scale_log2;
      }
      float p = ex2(x - lse);
      if constexpr (MASK) {
        const int qp = q0 + 8 * j + 2 * t + (e & 1);
        if (!((qp >= lo[r] && qp < hi[r]) || qp < pe[r])) p = 0.f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - dl) * dcap;
    }
  }
}

template <bool SOFTCAP>
__device__ __forceinline__ void p_ds_keys_any(bool mask, float (&s)[QT / 2],
                                              float (&dp)[QT / 2], const float* lse_s,
                                              const float* dl_s, int q0, const int (&key)[2],
                                              int t, int S, int Tk, int window, int prefix,
                                              float scale_log2, float scale, float cap) {
  if (mask)
    p_ds_keys<true, SOFTCAP>(s, dp, lse_s, dl_s, q0, key, t, S, Tk, window, prefix, scale_log2,
                             scale, cap);
  else
    p_ds_keys<false, SOFTCAP>(s, dp, lse_s, dl_s, q0, key, t, S, Tk, window, prefix,
                              scale_log2, scale, cap);
}

// dS of one 64-query x 64-key tile of dQ, in place: s holds S = Q K^T, dp
// holds dP = dO V^T; the thread's queries (rows) are row[0] and row[1],
// with lse2 (lse in log2 units) and dl (D); the key of s[i] is k0 + 8 (i /
// 4) + 2t + i % 2.  Row s sees the keys in (lo, hi] and those below pe, as
// in K3's forward (softmax_tile).  A row at or past S has zero Q and dO,
// lse and D 0, and so dS 0.  On return s holds dS.
template <bool MASK, bool SOFTCAP>
__device__ __forceinline__ void ds_rows(float (&s)[KT / 2], const float (&dp)[KT / 2], int k0,
                                        const int (&row)[2], const float (&lse2)[2],
                                        const float (&dl)[2], int t, int Tk, int window,
                                        int prefix, float scale_log2, float scale, float cap) {
  int hi[2], lo[2], pe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = min(row[r], Tk - 1);
    lo[r] = window ? row[r] - window : -1;
    pe[r] = row[r] < prefix ? min(prefix, Tk) : 0;
  }
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x, dcap = 1.f;
    if constexpr (SOFTCAP) {
      const float th = tanhf(s[i] * scale / cap);
      x = cap * th * LOG2E;
      dcap = 1.f - th * th;
    } else {
      x = s[i] * scale_log2;
    }
    float p = ex2(x - lse2[r]);
    if constexpr (MASK) {
      const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!((kp <= hi[r] && kp > lo[r]) || kp < pe[r])) p = 0.f;
    }
    s[i] = p * (dp[i] - dl[r]) * dcap;
  }
}

template <bool SOFTCAP>
__device__ __forceinline__ void ds_rows_any(bool mask, float (&s)[KT / 2],
                                            const float (&dp)[KT / 2], int k0,
                                            const int (&row)[2], const float (&lse2)[2],
                                            const float (&dl)[2], int t, int Tk, int window,
                                            int prefix, float scale_log2, float scale,
                                            float cap) {
  if (mask)
    ds_rows<true, SOFTCAP>(s, dp, k0, row, lse2, dl, t, Tk, window, prefix, scale_log2, scale,
                           cap);
  else
    ds_rows<false, SOFTCAP>(s, dp, k0, row, lse2, dl, t, Tk, window, prefix, scale_log2, scale,
                            cap);
}

// (a) dK and dV of one (batch, query head, KB-key tile) into the float32
// (B, Tk, H, HD) workspaces.  tm_q/tm_do: QT-row boxes, tm_k/tm_v: KB-row
// boxes (the _tail maps: hd 80's 16-column chunk).  1-D grid of
// ceil(Tk / KB) * H * B blocks, the first key tiles first.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                  const float* __restrict__ dlt, float* __restrict__ dk_ws,
                  float* __restrict__ dv_ws, __nv_bfloat16* __restrict__ dk_out,
                  __nv_bfloat16* __restrict__ dv_out, int S, int Sp, int Tk, int H, int KVH, int B,
                  float scale, float cap, int window, int prefix,
                  const __grid_constant__ CUtensorMap tm_q_tail,
                  const __grid_constant__ CUtensorMap tm_do_tail,
                  const __grid_constant__ CUtensorMap tm_k_tail,
                  const __grid_constant__ CUtensorMap tm_v_tail) {
  using C = Cfg<HD>;
  constexpr int NCH = C::NCH, KB = C::KB, STAGES = C::KV_STAGES, COLS = C::COLS;
  extern __shared__ unsigned char smem_raw[];
  // every chunk starts on 1 KB (a 128-byte swizzle atom)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + C::KV_BYTES;
  const uint32_t stat = k_s + C::DKDV_STAT;
  const uint32_t bars = k_s + C::DKDV_BAR;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto q_tile = [&](int st) { return k_s + C::DKDV_RING + 2 * st * C::QT_BYTES; };
  auto do_tile = [&](int st) { return k_s + C::DKDV_RING + (2 * st + 1) * C::QT_BYTES; };
  auto lse_at = [&](int st) { return stat + 2 * st * C::STAT_BYTES; };   // D follows

  const int bh = blockIdx.x % (H * B);
  const int k0 = blockIdx.x / (H * B) * KB;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  // the query tiles i0 .. i0 + n - 1 hold every query that sees a key of
  // the tile; ring position i holds tile i0 + i
  const Range qr = query_range(k0, min(k0 + KB, Tk), S, window, prefix);
  const int i0 = qr.begin / QT;
  const int n = qr.begin < qr.end ? (qr.end + QT - 1) / QT - i0 : 0;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);     // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load(&tm_k, kv_full, k_s + c * KB * 128, c * CW, kvh, k0, b);
        tma_load(&tm_v, kv_full, v_s + c * KB * 128, c * CW, kvh, k0, b);
      }
      if constexpr (C::TAIL) {
        tma_load(&tm_k_tail, kv_full, k_s + NCH * KB * 128, NCH * CW, kvh, k0, b);
        tma_load(&tm_v_tail, kv_full, v_s + NCH * KB * 128, NCH * CW, kvh, k0, b);
      }
      const long long row0 = (static_cast<long long>(b) * H + h) * Sp;
      const uint64_t keep = l2_evict_last();   // every key tile of the head reads them
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, q0 = (i0 + i) * QT;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);   // passes on the first round
        mbar_expect_tx(full(st), 2 * C::QT_BYTES + 2 * C::STAT_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(&tm_q, full(st), q_tile(st) + c * QT * 128, c * CW, h, q0, b);
          tma_load(&tm_do, full(st), do_tile(st) + c * QT * 128, c * CW, h, q0, b);
        }
        if constexpr (C::TAIL) {
          tma_load(&tm_q_tail, full(st), q_tile(st) + NCH * QT * 128, NCH * CW, h, q0, b);
          tma_load(&tm_do_tail, full(st), do_tile(st) + NCH * QT * 128, NCH * CW, h, q0, b);
        }
        bulk_load(lse_at(st), lse + row0 + q0, C::STAT_BYTES, full(st), keep);
        bulk_load(lse_at(st) + C::STAT_BYTES, dlt + row0 + q0, C::STAT_BYTES, full(st), keep);
      }
    }
  } else {
    // ---- consumers: 64 keys each (at hd 256 the same 64, and half the
    // columns each)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
    const int t = lane & 3;
    const int rows = C::SPLIT ? 0 : 64 * (wg - 1);            // this warpgroup's first key
    const int kw = k0 + rows;
    const int key[2] = {kw + 16 * warp + (lane >> 2), kw + 16 * warp + (lane >> 2) + 8};
    const uint32_t k_rows = k_s + rows * 128, v_rows = v_s + rows * 128;
    const uint32_t k_tail = k_s + NCH * KB * 128 + rows * TW * 2;   // hd 80
    const uint32_t v_tail = v_s + NCH * KB * 128 + rows * TW * 2;
    // this warpgroup's dK and dV columns: the 128-byte chunks from col / 64
    const int col = C::SPLIT ? COLS * (wg - 1) : 0;
    const uint32_t col_off = col / CW * QT * 128;
    const float* stat_f = reinterpret_cast<const float*>(smem_raw + (stat - raw));
    const float scale_log2 = scale * LOG2E;

    float dk[COLS / 2], dv[COLS / 2], s[QT / 2], dp[QT / 2];
    uint32_t pf[QT / 16][4], dsf[QT / 16][4];
#pragma unroll
    for (int i = 0; i < COLS / 2; ++i) dk[i] = dv[i] = 0.f;

    // With KV_PIPE, S^T_i and dP^T_i are issued together with the previous
    // tile's dV and dK products, and p and dS of tile i are computed (in
    // float32, in s and dp) while those run; they are rounded into pf and
    // dsf once the previous products, which read pf and dsf, are done.
    // Otherwise each tile's products wait for its math (Cfg::KV_PIPE).
    auto p_ds = [&](int i) {
      const int st = i % STAGES, q0 = (i0 + i) * QT;
      const float* lse_s = stat_f + 2 * st * QT;
      p_ds_keys_any<SOFTCAP>(!all_visible(kw, q0, S, Tk, window, prefix), s, dp, lse_s,
                             lse_s + QT, q0, key, t, S, Tk, window, prefix, scale_log2, scale,
                             cap);
    };
    auto issue_st = [&](int i) {
      const int st = i % STAGES;
      mbar_wait(full(st), (i / STAGES) & 1);
      issue_ss<HD, KB, QT>(s, k_rows, k_tail, q_tile(st));     // S^T = K Q^T
      issue_ss<HD, KB, QT>(dp, v_rows, v_tail, do_tile(st));   // dP^T = V dO^T
      wgmma_commit();
    };
    auto issue_dkdv = [&](int i) {
      const int st = i % STAGES;
      issue_rs<COLS, QT>(dv, pf, do_tile(st) + col_off);    // dV += P^T dO
      issue_rs<COLS, QT>(dk, dsf, q_tile(st) + col_off);    // dK += dS^T Q
      wgmma_commit();
    };
    auto release = [&](int i) {
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      mbar_arrive_if(empty(i % STAGES), lane == 0);
    };

    mbar_wait(kv_full, 0);
    if constexpr (C::KV_PIPE) {
      if (n > 0) {
        wgmma_fence();
        issue_st(0);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        p_ds(0);
        to_bf16(s, pf);
        to_bf16(dp, dsf);
      }
      for (int i = 1; i < n; ++i) {
        wgmma_fence();                    // pf, dsf, s and dp were written by ordinary code
        issue_st(i);
        issue_dkdv(i - 1);
        wgmma_wait<1>();                  // S^T_i, dP^T_i done; tile i - 1's products may run
        fence_regs(s);
        fence_regs(dp);
        p_ds(i);
        wgmma_wait<0>();
        release(i - 1);
        to_bf16(s, pf);
        to_bf16(dp, dsf);
      }
      if (n > 0) {
        wgmma_fence();
        issue_dkdv(n - 1);
        wgmma_wait<0>();
        release(n - 1);
      }
    } else {
      for (int i = 0; i < n; ++i) {
        wgmma_fence();
        issue_st(i);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        p_ds(i);
        to_bf16(s, pf);
        to_bf16(dp, dsf);
        wgmma_fence();
        issue_dkdv(i);
        wgmma_wait<0>();
        release(i);
      }
    }

    // dK and dV of this query head: in bfloat16 (dK scaled) where it is its
    // KV head's only one, else to the workspace for group_sum_kernel
    const bool alone = H == KVH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= Tk) continue;
      const long long at =
          ((static_cast<long long>(b) * Tk + key[r]) * H + h) * HD + col + 2 * t;
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j) {
        if (alone) {
          *reinterpret_cast<uint32_t*>(dk_out + at + 8 * j) =
              pack_bf16(dk[4 * j + 2 * r] * scale, dk[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv_out + at + 8 * j) =
              pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        } else {
          *reinterpret_cast<float2*>(dk_ws + at + 8 * j) =
              make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_ws + at + 8 * j) =
              make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// (b) dQ of one (batch, query head, QB-row block).  tm_q/tm_do: QB-row
// boxes, tm_k/tm_v: KT-row boxes.  1-D grid of ceil(S / QB) * H * B blocks,
// the last query blocks (the most keys under the causal mask) first.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NT, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                const float* __restrict__ dlt, __nv_bfloat16* __restrict__ dq, int S, int Sp,
                int Tk, int H, int KVH, int B, float scale, float cap, int window, int prefix,
                const __grid_constant__ CUtensorMap tm_q_tail,
                const __grid_constant__ CUtensorMap tm_do_tail,
                const __grid_constant__ CUtensorMap tm_k_tail,
                const __grid_constant__ CUtensorMap tm_v_tail) {
  using C = Cfg<HD>;
  constexpr int NCH = C::NCH, STAGES = C::DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + C::QB_BYTES;
  const uint32_t bars = q_s + C::DQ_BAR;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto k_tile = [&](int st) { return q_s + C::DQ_RING + 2 * st * C::KT_BYTES; };
  auto v_tile = [&](int st) { return q_s + C::DQ_RING + (2 * st + 1) * C::KT_BYTES; };

  const int nqb = (S + QB - 1) / QB;
  const int bh = blockIdx.x % (H * B);
  const int q0 = (nqb - 1 - blockIdx.x / (H * B)) * QB;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KVH);
  // the key tiles j0 .. j0 + n - 1 hold every key some row sees; ring
  // position i holds tile j0 + i
  const Range kr = key_range(q0, min(q0 + QB, S), Tk, window, prefix);
  const int j0 = kr.begin / KT;
  const int n = kr.begin < kr.end ? (kr.end + KT - 1) / KT - j0 : 0;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::QB_BYTES);
      for (int c = 0; c < NCH; ++c) {
        tma_load(&tm_q, q_full, q_s + c * QB * 128, c * CW, h, q0, b);
        tma_load(&tm_do, q_full, do_s + c * QB * 128, c * CW, h, q0, b);
      }
      if constexpr (C::TAIL) {
        tma_load(&tm_q_tail, q_full, q_s + NCH * QB * 128, NCH * CW, h, q0, b);
        tma_load(&tm_do_tail, q_full, do_s + NCH * QB * 128, NCH * CW, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, k0 = (j0 + i) * KT;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * C::KT_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(&tm_k, full(st), k_tile(st) + c * KT * 128, c * CW, kvh, k0, b);
          tma_load(&tm_v, full(st), v_tile(st) + c * KT * 128, c * CW, kvh, k0, b);
        }
        if constexpr (C::TAIL) {
          tma_load(&tm_k_tail, full(st), k_tile(st) + NCH * KT * 128, NCH * CW, kvh, k0, b);
          tma_load(&tm_v_tail, full(st), v_tile(st) + NCH * KT * 128, NCH * CW, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
    const int t = lane & 3;
    const int r0 = q0 + 64 * (wg - 1);                        // this warpgroup's first row
    const int row[2] = {r0 + 16 * warp + (lane >> 2), r0 + 16 * warp + (lane >> 2) + 8};
    const uint32_t q_rows = q_s + (wg - 1) * 64 * 128, do_rows = do_s + (wg - 1) * 64 * 128;
    const uint32_t q_tail = q_s + NCH * QB * 128 + (wg - 1) * 64 * TW * 2;   // hd 80
    const uint32_t do_tail = do_s + NCH * QB * 128 + (wg - 1) * 64 * TW * 2;
    const float scale_log2 = scale * LOG2E;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sp;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = row[r] < S ? lse[row0 + row[r]] * LOG2E : 0.f;
      dl[r] = row[r] < S ? dlt[row0 + row[r]] : 0.f;
    }

    float dqa[HD / 2], s[KT / 2], dp[KT / 2];
    uint32_t dsf[KT / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

    // With DQ_PIPE, as in dK/dV: S_i and dP_i are issued with the
    // previous tile's dQ product, dS_i is computed while it runs and
    // rounded into dsf after
    auto ds_of = [&](int i) {
      const int k0 = (j0 + i) * KT;
      ds_rows_any<SOFTCAP>(!all_visible(k0, r0, S, Tk, window, prefix), s, dp, k0, row, lse2,
                           dl, t, Tk, window, prefix, scale_log2, scale, cap);
    };
    auto issue_sdp = [&](int i) {
      const int st = i % STAGES;
      mbar_wait(full(st), (i / STAGES) & 1);
      issue_ss<HD, QB, KT>(s, q_rows, q_tail, k_tile(st));     // S = Q K^T
      issue_ss<HD, QB, KT>(dp, do_rows, do_tail, v_tile(st));  // dP = dO V^T
      wgmma_commit();
    };
    auto issue_dq = [&](int i) {
      issue_rs<HD, KT>(dqa, dsf, k_tile(i % STAGES));          // dQ += dS K
      wgmma_commit();
    };
    auto release = [&](int i) {
      fence_regs(dqa);
      fence_regs(dsf);
      mbar_arrive_if(empty(i % STAGES), lane == 0);
    };

    mbar_wait(q_full, 0);
    if constexpr (C::DQ_PIPE) {
      if (n > 0) {
        wgmma_fence();
        issue_sdp(0);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        ds_of(0);
        to_bf16(s, dsf);
      }
      for (int i = 1; i < n; ++i) {
        wgmma_fence();
        issue_sdp(i);
        issue_dq(i - 1);
        wgmma_wait<1>();                  // S_i, dP_i done; tile i - 1's dQ product may run
        fence_regs(s);
        fence_regs(dp);
        ds_of(i);
        wgmma_wait<0>();
        release(i - 1);
        to_bf16(s, dsf);
      }
      if (n > 0) {
        wgmma_fence();
        issue_dq(n - 1);
        wgmma_wait<0>();
        release(n - 1);
      }
    } else {
      for (int i = 0; i < n; ++i) {
        wgmma_fence();
        issue_sdp(i);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        ds_of(i);
        to_bf16(s, dsf);
        wgmma_fence();
        issue_dq(i);
        wgmma_wait<0>();
        release(i);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= S) continue;
      __nv_bfloat16* dq_row = dq + ((static_cast<long long>(b) * S + row[r]) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
    }
  }
}

// (c) dK = scale * sum over g of dk_ws[.., kvh * G + g, ..] and dV = the
// same sum of dv_ws, g ascending, in bfloat16: 4 columns a thread.  n =
// B * Tk * KVH * HD / 4.
__global__ void __launch_bounds__(256)
group_sum_kernel(const float4* __restrict__ dk_ws, const float4* __restrict__ dv_ws,
                 uint2* __restrict__ dk, uint2* __restrict__ dv, long long n, int G, int hd4,
                 float scale) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += gridDim.x * 256ll) {
    const long long src = (i / hd4 * G) * hd4 + i % hd4;   // (b, t, kvh * G, c)
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int g = 0; g < G; ++g) {
      const float4 x = dk_ws[src + g * hd4], y = dv_ws[src + g * hd4];
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
    }
    dk[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
    dv[i] = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* dlt, void* dq, void* dk, void* dv, float* ws, int B, int S, int Sp,
           int Tk, int H, int KVH, float scale, bool softcap, float cap, int window, int prefix,
           cudaStream_t stream) {
  const bool grouped = H != KVH;   // dK, dV go through the workspace and group_sum_kernel
  if (grouped && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int KB = Cfg<HD>::KB;
  constexpr auto SW = CU_TENSOR_MAP_SWIZZLE_128B;
  // dK/dV: Q, dO in QT-row boxes, K, V in KB-row boxes; dQ: QB and KT
  CUtensorMap a_q, a_do, a_k, a_v, b_q, b_do, b_k, b_v;
  if (!encode(&a_q, q, HD, H, S, B, QT, CW, SW) || !encode(&a_do, dout, HD, H, S, B, QT, CW, SW) ||
      !encode(&a_k, k, HD, KVH, Tk, B, KB, CW, SW) || !encode(&a_v, v, HD, KVH, Tk, B, KB, CW, SW) ||
      !encode(&b_q, q, HD, H, S, B, QB, CW, SW) || !encode(&b_do, dout, HD, H, S, B, QB, CW, SW) ||
      !encode(&b_k, k, HD, KVH, Tk, B, KT, CW, SW) || !encode(&b_v, v, HD, KVH, Tk, B, KT, CW, SW))
    return static_cast<int>(cudaErrorInvalidValue);
  // the tail's maps, hd 80 only
  CUtensorMap a_qt = a_q, a_dot = a_do, a_kt = a_k, a_vt = a_v;
  CUtensorMap b_qt = b_q, b_dot = b_do, b_kt = b_k, b_vt = b_v;
  if constexpr (Cfg<HD>::TAIL) {
    constexpr auto SWT = CU_TENSOR_MAP_SWIZZLE_32B;
    if (!encode(&a_qt, q, HD, H, S, B, QT, TW, SWT) ||
        !encode(&a_dot, dout, HD, H, S, B, QT, TW, SWT) ||
        !encode(&a_kt, k, HD, KVH, Tk, B, KB, TW, SWT) ||
        !encode(&a_vt, v, HD, KVH, Tk, B, KB, TW, SWT) ||
        !encode(&b_qt, q, HD, H, S, B, QB, TW, SWT) ||
        !encode(&b_dot, dout, HD, H, S, B, QB, TW, SWT) ||
        !encode(&b_kt, k, HD, KVH, Tk, B, KT, TW, SWT) ||
        !encode(&b_vt, v, HD, KVH, Tk, B, KT, TW, SWT))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  float* dk_ws = ws;
  float* dv_ws = grouped ? ws + static_cast<long long>(B) * Tk * H * HD : nullptr;
  return with_flag(softcap, [&](auto SOFTCAP) {
    constexpr bool kCap = decltype(SOFTCAP)::value;
    auto dkdv = dkdv_wgmma_kernel<HD, kCap>;
    auto dqk = dq_wgmma_kernel<HD, kCap>;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(Cfg<HD>::dkdv_bytes))) != cudaSuccess ||
        (err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(Cfg<HD>::dq_bytes))) != cudaSuccess)
      return static_cast<int>(err);
    dkdv<<<(Tk + KB - 1) / KB * H * B, NT, Cfg<HD>::dkdv_bytes, stream>>>(
        a_q, a_do, a_k, a_v, lse, dlt, dk_ws, dv_ws, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), S, Sp, Tk, H, KVH, B, scale, cap, window, prefix, a_qt,
        a_dot, a_kt, a_vt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dqk<<<(S + QB - 1) / QB * H * B, NT, Cfg<HD>::dq_bytes, stream>>>(
        b_q, b_do, b_k, b_v, lse, dlt, static_cast<__nv_bfloat16*>(dq), S, Sp, Tk, H, KVH, B,
        scale, cap, window, prefix, b_qt, b_dot, b_kt, b_vt);
    if ((err = cudaGetLastError()) != cudaSuccess || !grouped) return static_cast<int>(err);
    const long long n = static_cast<long long>(B) * Tk * KVH * (HD / 4);
    const long long want = (n + 255) / 256;   // a grid-stride loop past 16 blocks an SM
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    group_sum_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(dk_ws), reinterpret_cast<const float4*>(dv_ws),
        static_cast<uint2*>(dk), static_cast<uint2*>(dv), n, H / KVH, HD / 4, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace hopper

// prep_kernel, then the Hopper kernels (bfloat16 at hd 64, 80, 128, 256) or
// the mma.sync / FMA kernels (bfloat16 at hd 16 and 32, and float32).
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* lse_p, float* dlt, float* ws,
           int B, int S, int Tk, int H, int KVH, float scale, bool softcap, float cap,
           int window, int prefix, cudaStream_t stream) {
  const int Sp = (S + ROWS - 1) / ROWS * ROWS;
  prep_kernel<T><<<dim3(Sp / ROWS, H, B), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, lse_p, dlt, S, Sp, H, HD);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<T, __nv_bfloat16> && (HD == 64 || HD == 80 || HD == 128 ||
                                                      HD == 256))
    return hopper::launch<HD>(q, k, v, dout, lse_p, dlt, dq, dk, dv, ws, B, S, Sp, Tk, H, KVH,
                              scale, softcap, cap, window, prefix, stream);
  else
    return with_flag(softcap, [&](auto SOFTCAP) {
      return mma::launch<T, HD, decltype(SOFTCAP)::value>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(dout), lse_p, dlt, static_cast<T*>(dq), static_cast<T*>(dk),
          static_cast<T*>(dv), B, S, Sp, Tk, H, KVH, scale, cap, window, prefix, stream);
    });
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dq, void* dk, void* dv, float* lse_p,
             float* dlt, float* ws, int B, int S, int Tk, int H, int KVH, float scale,
             bool softcap, float cap, int window, int prefix, cudaStream_t stream) {
#define REPRO_BWD_CASE(HD)                                                                   \
  case HD:                                                                                   \
    return launch<T, HD>(q, k, v, o, dout, lse, dq, dk, dv, lse_p, dlt, ws, B, S, Tk, H, KVH, \
                         scale, softcap, cap, window, prefix, stream);
  switch (hd) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_CASE
}

}  // namespace flash_bwd
}  // namespace repro

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, KVH, hd); contiguous,
// one dtype (0 = float32, 2 = bfloat16); H a multiple of KVH; hd in {16,
// 32, 64, 80, 128, 256}; the causal mask, window > 0 keeping keys
// t > s - window and prefix > 0 opening the prefix's square (0: none);
// softcap <= 0 means none.  lse: (B, H, S) float32, the forward's row
// statistics (repro_flash_attention's lse).  Scratch: lse_p and delta,
// (B, H, Sp) float32 each with Sp = S rounded up to a multiple of 64; ws,
// 2 x (B, T, H, hd) float32 for bfloat16 at hd 64, 80, 128 and 256 with
// H > KVH (may be null otherwise).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* lse_p,
                                         void* delta, void* ws, int B, int S, int T, int H,
                                         int KVH, int hd, int dtype, double scale,
                                         double softcap, int window, int prefix, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T <= 0 || window < 0 || prefix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  auto* l = static_cast<const float*>(lse);
  auto* lp = static_cast<float*>(lse_p);
  auto* d = static_cast<float*>(delta);
  auto* w = static_cast<float*>(ws);
  if (dtype == 0)
    return repro::flash_bwd::dispatch<float>(hd, q, k, v, o, dout, l, dq, dk, dv, lp, d, w, B,
                                             S, T, H, KVH, sc, softcap > 0, cap, window, prefix,
                                             s);
  if (dtype == 2)
    return repro::flash_bwd::dispatch<__nv_bfloat16>(hd, q, k, v, o, dout, l, dq, dk, dv, lp, d,
                                                     w, B, S, T, H, KVH, sc, softcap > 0, cap,
                                                     window, prefix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
