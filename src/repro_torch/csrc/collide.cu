// Collision kernel (K2): one LBM collision per node over the (Q, T, n) state.
//
// Replaces the Pallas kernel src/repro/kernels/collide.py::collide_pallas
// (bodies _kernel_lbgk and _kernel_mrt, math _collide_block), reached
// through src/repro/kernels/ops.py::collide_tiles.  The TPU version packs
// two tiles per 128-lane row; on Hopper one thread takes one node, and the
// warp's 32 neighbouring nodes make each of the Q loads and stores one
// coalesced transaction per direction.
//
// Bound on the H100: memory bytes.  Each node reads Q values and one solid
// flag and writes Q values, 2*Q*sizeof(T) + 1 bytes, against at most
// ~2*Q*Q flops for MRT (about 1.2 flop per byte in f64) — far below the
// card's ratio of flops to bytes.  The design therefore does nothing but
// keep every global access coalesced and read each value once; the MRT
// matrix sits in shared memory.
#include "collide.cuh"

namespace repro {

template <typename T, int Q, bool MRT, bool QUASI, bool FORCE>
__global__ void __launch_bounds__(256)
collide_kernel(const T* __restrict__ f, const uint8_t* __restrict__ solid,
               const T* __restrict__ A, T* __restrict__ out, long long m,
               CollideParams<T> p) {
  __shared__ T a_sh[MRT ? Q * Q : 1];
  if constexpr (MRT) {
    for (int i = threadIdx.x; i < Q * Q; i += blockDim.x) a_sh[i] = A[i];
    __syncthreads();
  }
  const long long node = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (node >= m) return;
  T v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = f[q * m + node];
  collide_node<T, Q, MRT, QUASI, FORCE>(v, solid[node] != 0, a_sh, p);
#pragma unroll
  for (int q = 0; q < Q; ++q) out[q * m + node] = v[q];
}

template <typename T, int Q>
int launch_collide(const void* f, const void* solid, const void* A, void* out,
                   long long m, bool mrt, bool quasi, bool force,
                   CollideParams<T> p, cudaStream_t stream) {
  const int block = 256;
  const unsigned grid = static_cast<unsigned>((m + block - 1) / block);
  return with_flag(mrt, [&](auto MRT) {
    return with_flag(quasi, [&](auto QUASI) {
      return with_flag(force, [&](auto FORCE) {
        if constexpr (decltype(MRT)::value && Q != 19) {
          return static_cast<int>(cudaErrorInvalidValue);
        } else {
          collide_kernel<T, Q, decltype(MRT)::value, decltype(QUASI)::value,
                         decltype(FORCE)::value><<<grid, block, 0, stream>>>(
              static_cast<const T*>(f), static_cast<const uint8_t*>(solid),
              static_cast<const T*>(A), static_cast<T*>(out), m, p);
          return static_cast<int>(cudaGetLastError());
        }
      });
    });
  });
}

template <typename T>
int dispatch_collide(const void* f, const void* solid, const void* A, void* out,
                     long long m, int q, int mrt, int quasi, int force,
                     double inv_tau, double tau_fx, double tau_fy, double tau_fz,
                     cudaStream_t stream) {
  const CollideParams<T> p{T(inv_tau), T(tau_fx), T(tau_fy), T(tau_fz)};
  if (q == 19) return launch_collide<T, 19>(f, solid, A, out, m, mrt, quasi, force, p, stream);
  if (q == 9) return launch_collide<T, 9>(f, solid, A, out, m, mrt, quasi, force, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// f, out: (Q, m) contiguous; solid: (m,) bytes, nonzero = solid; A: (Q, Q)
// or null.  dtype: 0 = float32, 1 = float64.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_collide_tiles(const void* f, const void* solid, const void* A,
                                   void* out, long long m, int q, int dtype, int mrt,
                                   int quasi, int force, double inv_tau, double tau_fx,
                                   double tau_fy, double tau_fz, void* stream) {
  if (m <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_collide<float>(f, solid, A, out, m, q, mrt, quasi, force,
                                          inv_tau, tau_fx, tau_fy, tau_fz, s);
  if (dtype == 1)
    return repro::dispatch_collide<double>(f, solid, A, out, m, q, mrt, quasi, force,
                                           inv_tau, tau_fx, tau_fy, tau_fz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
