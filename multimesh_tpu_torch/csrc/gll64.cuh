// f64 GLL tables and 1-D Lagrange cardinals for the f64 kernels
// (polish_pairs.cu, apply_pairs.cu).
//
// Nodes x_i and barycentric weights w_i = 1 / prod_{j != i}(x_i - x_j) are
// the f64 values of multimesh_tpu_torch/core/gll.py (gll_nodes,
// barycentric_weights), so a kernel and its plain twin evaluate the same
// polynomials.
#pragma once

#include <cuda_runtime.h>

namespace mmt_gll64 {

template <int ORDER> struct Gll;

template <> struct Gll<1> {
  __device__ __forceinline__ static double x(int i) {
    return i == 0 ? -1.0 : 1.0;
  }
  __device__ __forceinline__ static double w(int i) {
    return i == 0 ? -0.5 : 0.5;
  }
};

template <> struct Gll<2> {
  __device__ __forceinline__ static double x(int i) {
    return i == 0 ? -1.0 : (i == 1 ? 0.0 : 1.0);
  }
  __device__ __forceinline__ static double w(int i) {
    return i == 1 ? -1.0 : 0.5;
  }
};

template <> struct Gll<4> {
  __device__ __forceinline__ static double x(int i) {
    switch (i) {
      case 0: return -1.0;
      case 1: return -0.6546536707079771;
      case 2: return 0.0;
      case 3: return 0.6546536707079771;
      default: return 1.0;
    }
  }
  __device__ __forceinline__ static double w(int i) {
    switch (i) {
      case 0: return 0.8749999999999999;
      case 1: return -2.041666666666667;
      case 2: return 2.333333333333334;
      case 3: return -2.0416666666666665;
      default: return 0.8749999999999999;
    }
  }
};

// Cardinal values l_i(t) and, with DERIV, derivatives l_i'(t), in the
// product form l_i(t) = w_i prod_{j != i}(t - x_j) (gll.lagrange_eval /
// lagrange_deriv), fully unrolled.
template <int ORDER, bool DERIV>
__device__ __forceinline__ void lagrange(double t, double (&l)[ORDER + 1],
                                         double (&dl)[ORDER + 1]) {
  constexpr int N1 = ORDER + 1;
  double diff[N1];
#pragma unroll
  for (int j = 0; j < N1; ++j) diff[j] = t - Gll<ORDER>::x(j);
#pragma unroll
  for (int i = 0; i < N1; ++i) {
    double prod = 1.0;
#pragma unroll
    for (int j = 0; j < N1; ++j)
      if (j != i) prod *= diff[j];
    l[i] = Gll<ORDER>::w(i) * prod;
    if constexpr (DERIV) {
      double total = 0.0;
#pragma unroll
      for (int k = 0; k < N1; ++k) {
        if (k == i) continue;
        double term = 1.0;
#pragma unroll
        for (int j = 0; j < N1; ++j)
          if (j != i && j != k) term *= diff[j];
        total += term;
      }
      dl[i] = Gll<ORDER>::w(i) * total;
    }
  }
}

// a[i] for a runtime i without spilling the register array to local memory
template <int N>
__device__ __forceinline__ double pick(const double (&a)[N], int i) {
  double v = a[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (i == q) v = a[q];
  return v;
}

}  // namespace mmt_gll64
