// NEBB pass kernel: the open-boundary rebuild and the collision of the nodes
// of declared boundary types (inlets and outlets), after K1 has stepped
// every tile.
//
// Replaces no TPU kernel.  The JAX package runs its fused backend's NEBB
// pass as plain jnp (src/repro/core/backends.py:367-372), which XLA fuses
// into a few loops on the TPU; the port ran the same plain pass as ~68 aten
// launches a step over the whole boundary tiles.  K1 pulls the boundary
// nodes through the same tables and treats them as fluid, so only they need
// redoing: each thread takes one (boundary node, replica), pulls the node's
// Q post-streaming values from the pre-step packed state f through the
// node's Q source offsets (bounce-back and periodic edges folded in on the
// host), rebuilds the unknown populations by the node's BoundarySpec
// (core/boundary.py::apply_open_boundary: velocity or pressure, any
// axis-aligned normal), collides with collide_node (collide.cuh, under K1's
// template parameters) and writes the Q values to the node's slot of out.
// Every other slot keeps what K1 wrote.
//
// Bound on the H100: memory bytes.  A node reads Q values and Q int32
// offsets and writes Q values (19 x 20 B in f64), against ~100 flops (LBGK)
// to ~800 (MRT).  In the (T, Q, n) layout the nodes of a face normal to x
// sit 4 slots apart, so each value a node reads or writes is the only one
// of its 32-byte sector that the pass uses, and a write to a sector that L2
// does not hold also reads it: at the solver cell's 61,786 nodes in f64
// that is ~113 MB of sectors (~34 us at 3.35 TB/s) for 24 MB of values
// (7 us).  The design touches only the boundary nodes, not their tiles;
// reads int32 tables laid out direction-major, (Q, N), so a warp's 32
// neighbouring nodes read 32 neighbouring words a direction; makes ONE
// launch for every replica of an ensemble, adding the replica's base
// b * stride in 64 bits to offsets that are relative to one replica (so
// the tables are not copied per replica); and takes the specs by value
// among the kernel's parameters.  Only a fold into K1, which writes whole
// tile rows, would write fewer sectors.
#include "collide.cuh"

namespace repro {
namespace nebb {

constexpr int BLOCK = 128;
constexpr int MAX_SPECS = 8;
enum Kind { VELOCITY = 0, PRESSURE = 1 };

// One BoundarySpec: the normal points into the fluid.
struct Spec {
  int kind, nx, ny, nz;
  double ux, uy, uz, rho;
};
struct Specs {
  Spec s[MAX_SPECS];
};

// specs.s[k] by constant offsets only, so the parameters stay in the
// constant bank (a dynamic index would copy them to local memory).
__device__ __forceinline__ Spec pick(const Specs& specs, int k) {
  Spec s = specs.s[0];
#pragma unroll
  for (int i = 1; i < MAX_SPECS; ++i)
    if (i == k) s = specs.s[i];
  return s;
}

// The NEBB rebuild of one node in place, in apply_open_boundary's order:
// f_i = f_opp(i) + 2 w_i rho (e_i . u) 3 for every unknown direction
// (e_i . n > 0), with rho from the known populations (velocity) or the
// normal velocity from mass conservation (pressure).
template <typename T, int Q>
__device__ __forceinline__ void rebuild(T (&f)[Q], const Spec& s) {
  using S = Stencil<Q>;
  T f_par = T(0), f_out = T(0);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int en = S::ex(i) * s.nx + S::ey(i) * s.ny + S::ez(i) * s.nz;
    if (en == 0) f_par += f[i];
    if (en < 0) f_out += f[i];
  }
  T rho, ux, uy, uz;
  if (s.kind == VELOCITY) {
    ux = T(s.ux);
    uy = T(s.uy);
    uz = T(s.uz);
    T un = T(0);
    un = signed_add(un, s.nx, ux);
    un = signed_add(un, s.ny, uy);
    un = signed_add(un, s.nz, uz);
    rho = (f_par + T(2) * f_out) / (T(1) - un);
  } else {
    rho = T(s.rho);
    const T un = T(1) - (f_par + T(2) * f_out) / rho;
    ux = signed_add(T(0), s.nx, un);
    uy = signed_add(T(0), s.ny, un);
    uz = signed_add(T(0), s.nz, un);
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int en = S::ex(i) * s.nx + S::ey(i) * s.ny + S::ez(i) * s.nz;
    if (en > 0) {  // opp(i) is outgoing: never rebuilt, so read as pulled
      T eu = T(0);
      eu = signed_add(eu, S::ex(i), ux);
      eu = signed_add(eu, S::ey(i), uy);
      eu = signed_add(eu, S::ez(i), uz);
      f[i] = f[S::opp(i)] + T(2) * T(S::w(i)) * rho * eu * T(3);
    }
  }
}

}  // namespace nebb

// f, out: (B*T + 1, Q, n); src: (Q, nodes) int32 offsets into one replica's
// packed state; tiles, slots: (nodes,) int32; spec: (nodes,) uint8.
template <typename T, int Q, bool MRT, bool QUASI, bool FORCE>
__global__ void __launch_bounds__(nebb::BLOCK)
nebb_pass_kernel(const T* __restrict__ f, const int* __restrict__ src,
                 const int* __restrict__ tiles, const int* __restrict__ slots,
                 const uint8_t* __restrict__ spec, const T* __restrict__ A,
                 T* __restrict__ out, int nodes, int replicas, int n, long long stride,
                 nebb::Specs specs, CollideParams<T> p) {
  __shared__ T a_sh[MRT ? Q * Q : 1];
  if constexpr (MRT) {
    for (int i = threadIdx.x; i < Q * Q; i += blockDim.x) a_sh[i] = A[i];
    __syncthreads();
  }
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<long long>(nodes) * replicas) return;
  const int node = static_cast<int>(gid % nodes);
  const long long base = gid / nodes * stride;
  T v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = f[base + src[static_cast<long long>(q) * nodes + node]];
  nebb::rebuild<T, Q>(v, nebb::pick(specs, spec[node]));
  collide_node<T, Q, MRT, QUASI, FORCE>(v, false, a_sh, p);
  const long long dst = base + static_cast<long long>(tiles[node]) * Q * n + slots[node];
#pragma unroll
  for (int q = 0; q < Q; ++q) out[dst + q * n] = v[q];
}

template <typename T, int Q>
int launch_nebb(const void* f, const void* src, const void* tiles, const void* slots,
                const void* spec, const void* A, void* out, int nodes, int replicas, int n,
                long long stride, const nebb::Specs& specs, bool mrt, bool quasi, bool force,
                CollideParams<T> p, cudaStream_t stream) {
  const long long grid = (static_cast<long long>(nodes) * replicas + nebb::BLOCK - 1) / nebb::BLOCK;
  if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  return with_flag(mrt, [&](auto MRT) {
    return with_flag(quasi, [&](auto QUASI) {
      return with_flag(force, [&](auto FORCE) {
        if constexpr (decltype(MRT)::value && Q != 19) {
          return static_cast<int>(cudaErrorInvalidValue);
        } else {
          nebb_pass_kernel<T, Q, decltype(MRT)::value, decltype(QUASI)::value,
                           decltype(FORCE)::value>
              <<<static_cast<unsigned>(grid), nebb::BLOCK, 0, stream>>>(
                  static_cast<const T*>(f), static_cast<const int*>(src),
                  static_cast<const int*>(tiles), static_cast<const int*>(slots),
                  static_cast<const uint8_t*>(spec), static_cast<const T*>(A),
                  static_cast<T*>(out), nodes, replicas, n, stride, specs, p);
          return static_cast<int>(cudaGetLastError());
        }
      });
    });
  });
}

template <typename T>
int dispatch_nebb(const void* f, const void* src, const void* tiles, const void* slots,
                  const void* spec, const void* A, void* out, int nodes, int replicas, int q,
                  int n, long long stride, const nebb::Specs& specs, int mrt, int quasi,
                  int force, double inv_tau, double tau_fx, double tau_fy, double tau_fz,
                  cudaStream_t stream) {
  const CollideParams<T> p{T(inv_tau), T(tau_fx), T(tau_fy), T(tau_fz)};
  if (q == 19)
    return launch_nebb<T, 19>(f, src, tiles, slots, spec, A, out, nodes, replicas, n, stride,
                              specs, mrt, quasi, force, p, stream);
  if (q == 9)
    return launch_nebb<T, 9>(f, src, tiles, slots, spec, A, out, nodes, replicas, n, stride,
                             specs, mrt, quasi, force, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// f, out: (replicas * T + 1, Q, n) contiguous, out not aliasing f; src:
// (Q, nodes) int32 offsets into one replica's (T, Q, n) rows; tiles, slots:
// (nodes,) int32, the node's tile and slot; spec: (nodes,) uint8 index into
// the specs; stride: T * Q * n, the elements between two replicas' rows.
// spec_ints (host): kind (0 velocity, 1 pressure), nx, ny, nz per spec;
// spec_vals (host): ux, uy, uz, rho per spec.  A: (Q, Q) or null.  dtype: 0 =
// float32, 1 = float64.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_nebb_pass(const void* f, const void* src, const void* tiles,
                               const void* slots, const void* spec, const void* A, void* out,
                               int nodes, int replicas, int q, int n, long long stride,
                               int dtype, int num_specs, const int* spec_ints,
                               const double* spec_vals, int mrt, int quasi, int force,
                               double inv_tau, double tau_fx, double tau_fy, double tau_fz,
                               void* stream) {
  if (nodes <= 0 || replicas <= 0) return 0;
  if (num_specs < 1 || num_specs > repro::nebb::MAX_SPECS || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::nebb::Specs specs{};
  for (int k = 0; k < num_specs; ++k) {
    const int* i = spec_ints + 4 * k;
    const double* v = spec_vals + 4 * k;
    if (i[0] != repro::nebb::VELOCITY && i[0] != repro::nebb::PRESSURE)
      return static_cast<int>(cudaErrorInvalidValue);
    specs.s[k] = {i[0], i[1], i[2], i[3], v[0], v[1], v[2], v[3]};
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_nebb<float>(f, src, tiles, slots, spec, A, out, nodes, replicas, q, n,
                                       stride, specs, mrt, quasi, force, inv_tau, tau_fx,
                                       tau_fy, tau_fz, s);
  if (dtype == 1)
    return repro::dispatch_nebb<double>(f, src, tiles, slots, spec, A, out, nodes, replicas, q,
                                        n, stride, specs, mrt, quasi, force, inv_tau, tau_fx,
                                        tau_fy, tau_fz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
