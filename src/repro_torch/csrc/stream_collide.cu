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

// rw_only (paper §4.1): read and write each tile's own block, the
// bandwidth ceiling of the step.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
rw_kernel(const T* __restrict__ f, T* __restrict__ out, long long count) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride)
    out[i] = f[i];
}

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
  if (mode == RW_ONLY) {
    const long long count = static_cast<long long>(num_tiles) * q * n;
    const long long blocks = (count + BLOCK - 1) / BLOCK;
    const unsigned grid = static_cast<unsigned>(blocks < 65536 * 8 ? blocks : 65536 * 8);
    rw_kernel<T><<<grid, BLOCK, 0, stream>>>(static_cast<const T*>(f), static_cast<T*>(out),
                                             count);
    return static_cast<int>(cudaGetLastError());
  }
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
