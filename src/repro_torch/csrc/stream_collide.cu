// Fused stream + collide kernel (K1): one LBM step per non-empty tile over
// the packed (T+1, Q, n) state, the paper's Algorithm 2.
//
// Replaces the Pallas kernel src/repro/kernels/stream_collide.py::
// stream_collide_tiles (body make_kernel; _rw_kernel for mode rw_only).
// The TPU version scalar-prefetches the (T, 27) neighbour table and loads
// all 18 linked neighbour blocks whole into VMEM.  Here, as in the paper's
// own CUDA design (tile map in shared memory, Fig. 11), a block takes a few
// tiles, copies their 27 neighbour indices to shared memory, and each
// thread (one per node) pulls exactly one value and one node type per
// direction:
//
//   src tile = nbr[t, slot[q, s]],  src node = perm[q, s]
//   f_in[q]  = f[t, opp(q), s]  if that node is SOLID  (half-way bounce-back)
//            = f[src tile, q, src node]  otherwise
//
// Empty and out-of-grid neighbours point at the all-SOLID scratch tile T,
// and periodic axes wrap through the neighbour table, so neither needs a
// branch.  The Q pulled values stay in registers through the collision
// (collide.cuh, shared with the collision kernel) and are written once.
// The (Q, n) perm/slot tables are the same for every tile and stay in L1.
//
// Bound on the H100: memory bytes.  Per tile the step must read and write
// Q*n values plus n node types and 27 neighbour indices: for D3Q19 in f64,
// 19.6 KB per tile against ~50 flops per node for LBGK.  Each source value
// is read once from device memory; the neighbouring tiles' types and values
// that several tiles pull are served from L2.
//
// Mode rw_only (paper §4.1) replaces _rw_kernel (src/repro/kernels/
// stream_collide.py:194), which reads each tile's own (Q, n) block and
// writes it back: the step's bandwidth ceiling.  Bound: memory bytes,
// 2*T*Q*n*itemsize at 3.35 TB/s, with no arithmetic and no reuse, so the
// only lever is how many bytes each SM keeps in flight and how few
// instructions that takes.  The design moves the rows [0, T) as one run of
// bytes through Hopper's bulk-async copies (ring_kernel below); the
// register design (vec_kernel) takes what bulk copies cannot.
#include <atomic>

#include "async_copy.cuh"
#include "collide.cuh"

namespace repro {

enum Mode { FULL = 0, PROPAGATION_ONLY = 1, RW_ONLY = 2 };

constexpr int BLOCK = 256;
constexpr int NEIGHBORS = 27;

template <typename T, int Q, int MODE, bool MRT, bool QUASI, bool FORCE>
__global__ void __launch_bounds__(BLOCK)
stream_collide_kernel(const T* __restrict__ f, const uint8_t* __restrict__ types,
                      const int* __restrict__ nbrs, const int* __restrict__ perms,
                      const int8_t* __restrict__ slots, const T* __restrict__ A,
                      T* __restrict__ out, int num_tiles, int n, CollideParams<T> p) {
  using S = Stencil<Q>;
  const int tiles_per_block = blockDim.x / n;
  __shared__ int nbr_sh[BLOCK / 8 * NEIGHBORS];
  __shared__ T a_sh[MRT ? Q * Q : 1];

  const int tile0 = blockIdx.x * tiles_per_block;
  for (int i = threadIdx.x; i < tiles_per_block * NEIGHBORS; i += blockDim.x) {
    const int t = tile0 + i / NEIGHBORS;
    nbr_sh[i] = t < num_tiles ? nbrs[static_cast<long long>(t) * NEIGHBORS + i % NEIGHBORS]
                              : num_tiles;
  }
  if constexpr (MRT) {
    for (int i = threadIdx.x; i < Q * Q; i += blockDim.x) a_sh[i] = A[i];
  }
  __syncthreads();

  const int local = threadIdx.x / n;
  const int s = threadIdx.x - local * n;
  const int t = tile0 + local;
  if (local >= tiles_per_block || t >= num_tiles) return;
  const int* nb = nbr_sh + local * NEIGHBORS;
  const long long own = static_cast<long long>(t) * Q * n;

  T v[Q];
  v[0] = f[own + s];
#pragma unroll
  for (int q = 1; q < Q; ++q) {
    const int src_tile = nb[slots[q * n + s]];
    const int src_node = perms[q * n + s];
    if (types[static_cast<long long>(src_tile) * n + src_node] == SOLID) {
      v[q] = f[own + S::opp(q) * n + s];
    } else {
      v[q] = f[(static_cast<long long>(src_tile) * Q + q) * n + src_node];
    }
  }
  if constexpr (MODE == FULL) {
    const bool solid = types[static_cast<long long>(t) * n + s] == SOLID;
    collide_node<T, Q, MRT, QUASI, FORCE>(v, solid, a_sh, p);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) out[own + q * n + s] = v[q];
}

// ---------------------------------------------------------------------------
// rw_only: rows [0, T) of f copied into out, byte for byte.
//
// ring_kernel moves the run in chunks of CHUNK bytes: a one-warp block
// takes CHUNKS consecutive chunks, one thread starts a bulk load
// (cp.async.bulk into shared memory, completing the chunk's barrier in
// bytes) for each, and sends each chunk back out with a bulk store as it
// lands.  A handful of instructions moves each chunk.  What the H100 showed
// (PERF.md):
// - the grid is not persistent: the hardware hands the next block to
//   whichever SM frees first.  A persistent grid that split the chunks
//   evenly among the SMs ran ~4 % slower, and a block that walked 16
//   chunks through a 4-slot ring 2.5-3 % slower;
// - one block per SM (the launch reserves over half an SM's shared
//   memory) with its 3 chunks in flight at once, ~58 KB on each SM.  Two
//   chunks ran ~10 % slower; 4 or 6 chunks, or chunks twice as large, no
//   faster;
// - loads ask L2 to evict their lines last, stores first: without the
//   hints the kernel ran 0.7-1.6 % slower, level with Tensor.copy_.
// Bulk copies need addresses and sizes in multiples of 16 bytes: the part
// of the run aligned in both f and out goes in bulk, the head and tail
// (under 16 bytes each) as 4-byte words in block 0.
//
// vec_kernel takes what bulk copies cannot, f and out aligned unlike mod 16
// (a view with a storage offset): one word per thread, of the widest size
// at which both are aligned (8 or 4 bytes), with the same L2 hints.
// ---------------------------------------------------------------------------
namespace rw {

// Tuned on the H100 (PERF.md): bytes per chunk (two f64 or four f32 D3Q19
// tiles at n = 64) and chunks per block, all in flight at once.
constexpr int CHUNK = 19456;
constexpr int CHUNKS = 3;
constexpr int RING_BYTES = CHUNKS * CHUNK + 8 * CHUNKS;  // slots and their barriers
constexpr int VEC_BLOCK = 256;

// A run of bytes split at `align`: a head and a tail (each under `align`
// bytes, multiples of 4) around a body whose addresses in src and dst are
// both multiples of `align`.
struct Span {
  const char* src;
  char* dst;
  long long head, body, tail;
};

inline Span split(const void* src, void* dst, long long bytes, int align) {
  const auto s = reinterpret_cast<uintptr_t>(src);
  long long head = static_cast<long long>((align - s % align) % align);
  if (head > bytes) head = bytes;
  const long long body = (bytes - head) / align * align;
  return {static_cast<const char*>(src), static_cast<char*>(dst), head, body,
          bytes - head - body};
}

// Head and tail as 4-byte words, by the threads of block 0.
__device__ __forceinline__ void copy_edges(const Span& s) {
  if (blockIdx.x != 0) return;
  const int head = static_cast<int>(s.head / 4);
  const int words = head + static_cast<int>(s.tail / 4);
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const long long off = i < head ? 4ll * i : s.head + s.body + 4ll * (i - head);
    *reinterpret_cast<uint32_t*>(s.dst + off) = *reinterpret_cast<const uint32_t*>(s.src + off);
  }
}

__global__ void __launch_bounds__(32) ring_kernel(Span s) {
  extern __shared__ __align__(128) unsigned char ring[];
  copy_edges(s);
  const long long first = static_cast<long long>(blockIdx.x) * CHUNKS * CHUNK;
  if (threadIdx.x != 0 || first >= s.body) return;
  const long long left = s.body - first;
  const int mine = left < CHUNKS * CHUNK ? static_cast<int>((left + CHUNK - 1) / CHUNK) : CHUNKS;
  const uint64_t keep = l2_evict_last(), drop = l2_evict_first();
  const uint32_t base = smem_addr(ring), bars = base + CHUNKS * CHUNK;
  for (int k = 0; k < mine; ++k) mbar_init(bars + 8 * k, 1);
  mbar_init_fence();
  const char* src = s.src + s.head + first;
  char* dst = s.dst + s.head + first;
  auto size = [&](int k) {
    const long long rest = left - static_cast<long long>(k) * CHUNK;
    return static_cast<uint32_t>(rest < CHUNK ? rest : CHUNK);
  };
  for (int k = 0; k < mine; ++k) {
    mbar_expect_tx(bars + 8 * k, size(k));
    bulk_load(base + k * CHUNK, src + k * CHUNK, size(k), bars + 8 * k, keep);
  }
  for (int k = 0; k < mine; ++k) {
    mbar_wait(bars + 8 * k, 0);
    bulk_store(dst + k * CHUNK, base + k * CHUNK, size(k), drop);
    bulk_commit();
  }
  bulk_wait<0>();  // the stores have read shared memory before the block exits
}

// One word of global memory read or written with an L2 cache policy.
__device__ __forceinline__ uint2 load_hinted(const uint2* p, uint64_t policy) {
  uint2 v;
  asm volatile("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ uint32_t load_hinted(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm volatile("ld.global.L2::cache_hint.u32 %0, [%1], %2;\n" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ void store_hinted(uint2* p, uint2 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v2.u32 [%0], {%1, %2}, %3;\n" ::"l"(p), "r"(v.x),
               "r"(v.y), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void store_hinted(uint32_t* p, uint32_t v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.u32 [%0], %1, %2;\n" ::"l"(p), "r"(v), "l"(policy)
               : "memory");
}

template <typename W>
__global__ void __launch_bounds__(VEC_BLOCK) vec_kernel(Span s) {
  copy_edges(s);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s.body / static_cast<long long>(sizeof(W))) return;
  const W* src = reinterpret_cast<const W*>(s.src + s.head) + i;
  W* dst = reinterpret_cast<W*>(s.dst + s.head) + i;
  store_hinted(dst, load_hinted(src, l2_evict_last()), l2_evict_first());
}

// ring_kernel's dynamic shared memory: its slots, or over half of an SM's
// shared memory if that is more, so that one block runs per SM.  Read from
// the device and set on the kernel once per device.
inline int ring_smem(int* bytes) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  int smem = cached[dev].load(std::memory_order_relaxed);
  if (smem == 0) {
    int sm_smem = 0;
    err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    smem = RING_BYTES > sm_smem / 2 ? RING_BYTES : sm_smem / 2 + 1;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev].store(smem, std::memory_order_relaxed);
  }
  *bytes = smem;
  return 0;
}

// `bytes` from src to dst (both 4-byte aligned, not overlapping).  Returns
// a CUDA error code.
inline int copy(const void* src, void* dst, long long bytes, cudaStream_t stream) {
  const auto s = reinterpret_cast<uintptr_t>(src), d = reinterpret_cast<uintptr_t>(dst);
  if (s % 16 == d % 16) {
    const Span span = split(src, dst, bytes, 16);
    const long long grid = (span.body + CHUNKS * CHUNK - 1) / (CHUNKS * CHUNK);
    int smem = 0;
    const int err = ring_smem(&smem);
    if (err) return err;
    ring_kernel<<<static_cast<unsigned>(grid < 1 ? 1 : grid), 32, smem, stream>>>(span);
  } else {
    const int align = s % 8 == d % 8 ? 8 : 4;
    const Span span = split(src, dst, bytes, align);
    const long long grid = (span.body / align + VEC_BLOCK - 1) / VEC_BLOCK;
    if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned g = static_cast<unsigned>(grid < 1 ? 1 : grid);
    if (align == 8)
      vec_kernel<uint2><<<g, VEC_BLOCK, 0, stream>>>(span);
    else
      vec_kernel<uint32_t><<<g, VEC_BLOCK, 0, stream>>>(span);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rw

template <typename T, int Q>
int launch_step(const void* f, const void* types, const void* nbrs, const void* perms,
                const void* slots, const void* A, void* out, int num_tiles, int n,
                int mode, bool mrt, bool quasi, bool force, CollideParams<T> p,
                cudaStream_t stream) {
  const int tiles_per_block = BLOCK / n;
  const unsigned grid = static_cast<unsigned>((num_tiles + tiles_per_block - 1) / tiles_per_block);
  const int block = tiles_per_block * n;
  auto go = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(f), static_cast<const uint8_t*>(types),
        static_cast<const int*>(nbrs), static_cast<const int*>(perms),
        static_cast<const int8_t*>(slots), static_cast<const T*>(A),
        static_cast<T*>(out), num_tiles, n, p);
    return static_cast<int>(cudaGetLastError());
  };
  if (mode == PROPAGATION_ONLY) return go(stream_collide_kernel<T, Q, PROPAGATION_ONLY, false, false, false>);
  return with_flag(mrt, [&](auto MRT) {
    return with_flag(quasi, [&](auto QUASI) {
      return with_flag(force, [&](auto FORCE) {
        if constexpr (decltype(MRT)::value && Q != 19) {
          return static_cast<int>(cudaErrorInvalidValue);
        } else {
          return go(stream_collide_kernel<T, Q, FULL, decltype(MRT)::value,
                                          decltype(QUASI)::value, decltype(FORCE)::value>);
        }
      });
    });
  });
}

template <typename T>
int dispatch_step(const void* f, const void* types, const void* nbrs, const void* perms,
                  const void* slots, const void* A, void* out, int num_tiles, int q,
                  int n, int mode, int mrt, int quasi, int force, double inv_tau,
                  double tau_fx, double tau_fy, double tau_fz, cudaStream_t stream) {
  if (mode == RW_ONLY)
    return rw::copy(f, out, static_cast<long long>(num_tiles) * q * n * sizeof(T), stream);
  const CollideParams<T> p{T(inv_tau), T(tau_fx), T(tau_fy), T(tau_fz)};
  if (q == 19)
    return launch_step<T, 19>(f, types, nbrs, perms, slots, A, out, num_tiles, n, mode,
                              mrt, quasi, force, p, stream);
  if (q == 9)
    return launch_step<T, 9>(f, types, nbrs, perms, slots, A, out, num_tiles, n, mode,
                             mrt, quasi, force, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// f, out: (T+1, Q, n) contiguous (row T, the scratch tile, is neither read
// as a destination nor written); types: (T+1, n) uint8; nbrs: (T, 27) int32;
// perms: (Q, n) int32 source node; slots: (Q, n) int8 neighbour slot 0..26;
// A: (Q, Q) or null.  dtype: 0 = float32, 1 = float64.  mode: 0 full,
// 1 propagation_only, 2 rw_only.  n must divide 256.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_stream_collide_tiles(const void* f, const void* types, const void* nbrs,
                                          const void* perms, const void* slots, const void* A,
                                          void* out, int num_tiles, int q, int n, int dtype,
                                          int mode, int mrt, int quasi, int force,
                                          double inv_tau, double tau_fx, double tau_fy,
                                          double tau_fz, void* stream) {
  if (num_tiles <= 0) return 0;
  if (n <= 0 || n > repro::BLOCK || repro::BLOCK % n != 0 || repro::BLOCK / n > repro::BLOCK / 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_step<float>(f, types, nbrs, perms, slots, A, out, num_tiles, q, n,
                                       mode, mrt, quasi, force, inv_tau, tau_fx, tau_fy,
                                       tau_fz, s);
  if (dtype == 1)
    return repro::dispatch_step<double>(f, types, nbrs, perms, slots, A, out, num_tiles, q, n,
                                        mode, mrt, quasi, force, inv_tau, tau_fx, tau_fy,
                                        tau_fz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
