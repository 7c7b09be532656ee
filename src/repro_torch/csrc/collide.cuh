// Per-node LBM collision, shared by the collision kernel (collide.cu) and
// the fused stream+collide kernel (stream_collide.cu).
//
// The math of repro/kernels/collide.py::_collide_block, written once as a
// device function: rho = sum f, j = sum e f (the direction vectors are
// compile-time constants, so products with -1/0/+1 fold into adds, subs and
// skips), u = j or j/rho with rho guarded at solid slots, the body-force
// velocity shift, feq from Eqn 3 (quasi-compressible) or Eqn 4
// (incompressible), then the LBGK update f + (feq - f)/tau or the MRT update
// f + A (feq - f), and zero at solid slots.  All sums run in the storage
// type T (float or double), as the reference does.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr uint8_t SOLID = 0;

template <int Q>
struct Stencil;

// D3Q19 in the order of repro_torch/core/lattice.py (paper Fig. 1 naming).
template <>
struct Stencil<19> {
  __host__ __device__ static constexpr int ex(int i) {
    constexpr int v[19] = {0, 1, 0, -1, 0, 0, 0, 1, -1, -1, 1, 1, 0, -1, 0, 1, 0, -1, 0};
    return v[i];
  }
  __host__ __device__ static constexpr int ey(int i) {
    constexpr int v[19] = {0, 0, 1, 0, -1, 0, 0, 1, 1, -1, -1, 0, 1, 0, -1, 0, 1, 0, -1};
    return v[i];
  }
  __host__ __device__ static constexpr int ez(int i) {
    constexpr int v[19] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, 1, 1, 1, -1, -1, -1, -1};
    return v[i];
  }
  __host__ __device__ static constexpr int opp(int i) {
    constexpr int v[19] = {0, 3, 4, 1, 2, 6, 5, 9, 10, 7, 8, 17, 18, 15, 16, 13, 14, 11, 12};
    return v[i];
  }
  __host__ __device__ static constexpr double w(int i) {
    return i == 0 ? 1.0 / 3.0 : (i < 7 ? 1.0 / 18.0 : 1.0 / 36.0);
  }
};

// D2Q9 (z component zero).
template <>
struct Stencil<9> {
  __host__ __device__ static constexpr int ex(int i) {
    constexpr int v[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
    return v[i];
  }
  __host__ __device__ static constexpr int ey(int i) {
    constexpr int v[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
    return v[i];
  }
  __host__ __device__ static constexpr int ez(int) { return 0; }
  __host__ __device__ static constexpr int opp(int i) {
    constexpr int v[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
    return v[i];
  }
  __host__ __device__ static constexpr double w(int i) {
    return i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
  }
};

// Scalars of one collision configuration, rounded to T on the host exactly
// as the reference rounds its Python-float constants.
template <typename T>
struct CollideParams {
  T inv_tau;               // 1 / tau
  T tau_fx, tau_fy, tau_fz;  // tau * force
};

template <typename T>
__device__ __forceinline__ T signed_add(T acc, int sign, T v) {
  return sign > 0 ? acc + v : (sign < 0 ? acc - v : acc);
}

// Collide one node in place.  ``A`` is the (Q, Q) MRT matrix, row major, in
// shared memory (unused for LBGK).
template <typename T, int Q, bool MRT, bool QUASI, bool FORCE>
__device__ __forceinline__ void collide_node(T (&f)[Q], bool solid,
                                             const T* __restrict__ A,
                                             const CollideParams<T>& p) {
  using S = Stencil<Q>;
  T rho = f[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) rho += f[i];
  T jx = T(0), jy = T(0), jz = T(0);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    jx = signed_add(jx, S::ex(i), f[i]);
    jy = signed_add(jy, S::ey(i), f[i]);
    jz = signed_add(jz, S::ez(i), f[i]);
  }
  T ux, uy, uz, inv_rho = T(1);
  if constexpr (QUASI) {
    // one reciprocal, three multiplies; solid slots (rho = 0) stay finite
    inv_rho = T(1) / (solid ? T(1) : rho);
    ux = jx * inv_rho;
    uy = jy * inv_rho;
    uz = jz * inv_rho;
  } else {
    ux = jx;
    uy = jy;
    uz = jz;
  }
  if constexpr (FORCE) {
    if constexpr (QUASI) {
      ux = ux + p.tau_fx * inv_rho;
      uy = uy + p.tau_fy * inv_rho;
      uz = uz + p.tau_fz * inv_rho;
    } else {
      ux = ux + p.tau_fx;
      uy = uy + p.tau_fy;
      uz = uz + p.tau_fz;
    }
  }
  const T u2 = ux * ux + uy * uy + uz * uz;
  T delta[Q];  // feq - f
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const bool moving = S::ex(i) != 0 || S::ey(i) != 0 || S::ez(i) != 0;
    T eu = T(0);
    eu = signed_add(eu, S::ex(i), ux);
    eu = signed_add(eu, S::ey(i), uy);
    eu = signed_add(eu, S::ez(i), uz);
    const T poly = moving ? T(3) * eu + T(4.5) * (eu * eu) - T(1.5) * u2
                          : -T(1.5) * u2;
    const T wi = T(S::w(i));
    const T feq = QUASI ? wi * rho * (T(1) + poly) : wi * (rho + poly);
    delta[i] = feq - f[i];
  }
  if constexpr (MRT) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < Q; ++j) acc += A[i * Q + j] * delta[j];
      f[i] = f[i] + acc;
    }
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) f[i] = f[i] + delta[i] * p.inv_tau;
  }
  if (solid) {
#pragma unroll
    for (int i = 0; i < Q; ++i) f[i] = T(0);
  }
}

}  // namespace repro
